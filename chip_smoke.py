"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card, nvcc and the
trained checkpoint results/ckpts/parity_s0_fast_e15.pkl. Phases, each
printed with its elapsed seconds; any failed check raises, so the exit code
is not 0:

1. build   the CUDA kernels (one nvcc -c a source, all started together, then
           one link, into contrastboundary_tpu_torch/_build/<hash>/).
2. kernels window top-k and window gather against their plain PyTorch
           versions on the card, at every geometry of a B=2 x N=65536
           request: integer-grid clouds with duplicated rows (exact) and
           synthetic crops (values 1e-5, index disagreement <= 1e-4 of
           slots, which allows for near-ties); window top-k where no
           path takes it (k > W in the self and cross geometries,
           exclude_self), exact on the integer grid; and window gather
           directly at C in {1, 2, 3, 5, 35, 67, 131, 259, 1024} in the self
           and cross geometries, and from a misaligned x (the scalar-read
           path at C % 4 == 0), equal to the plain version.
3. serve   the trained flagship (full width, float32) on B=2 x N=65536
           crops of synthetic val room 0: one request with the launch counts
           reset just before and read just after (both must be > 0) and the
           running statistics untouched, three timed requests, and one with
           both kernels swapped for their plain versions (probs within 1e-3,
           argmax agreeing on >= 99.9% of points); crop overall accuracy
           must be >= 0.5.
4. timing  every kernel launch of that request replayed: kernel, plain
           version and one PyTorch library call, each with L2 flushed, beside
           its bound (bytes at 3.35 TB/s or FP32 operations at 67 TFLOP/s,
           the H100 SXM data sheet, whichever is larger); the largest
           window_topk call also 20 times through its wrapper and through
           its bare C entry.
5. profile the request split: pyramid alone and whole step (CUDA events),
           and one torch.profiler trace: device time by kernel and the
           device's busy share of the request.
6. voting  VotingEvaluator over room 0 for three requests.
7. stale-serve the same checkpoint in a bn_mode='stale' model, whose 18
           attention layers run the fused attention kernel: one request with
           the counts reset (pt_attn_fwd exactly 18), the running statistics
           untouched, three timed requests beside phase serve's median,
           probs against the plain versions' and against phase serve's
           batch-BN probs (eval-mode BN is the same function: 1e-3, argmax
           >= 99.9%), crop OA >= 0.5, three voting requests; each
           pt_attn_fwd launch against its plain version (1e-4 of scale, the
           same bits of out, s1 and s2 when run again), timed, and the times
           summed per width (C, M, K, launches, ms, bound).
8. train   the flagship train step (train/trainer.py::make_train_step: the
           training pyramid, the model in train mode, CE + 5-stage CBL,
           backward, SGD lr 0.05) from the checkpoint on B=2 x N=65536 crops
           of synthetic train rooms: one step with every launch count reset
           just before and read just after (all five kernels must be > 0; the
           searches wider than 2048 rows, plain PyTorch by the reference's
           width rule, are counted apart); one step with the kernels and one
           with the plain versions from the same weights and batch (loss rel
           <= 1e-4, global gradient norm rel <= 1e-3, running statistics rel
           <= 1e-4); five steps on that batch (every loss finite, the last
           below the first), the median of the three warm ones on the host
           clock, points/s and max_memory_allocated; one step under
           torch.profiler.
9. train-kernels every kernel call of that step against its plain version:
           window_topk and window_gather as in phase 2, window_gather_bwd
           max-abs <= 1e-5 of the output's scale (the plain version's
           index_add_ adds with atomics on the card), exact on integer
           cotangents, the same bits when run again, and bit-equal to the
           plain version on CPU copies (CPU index_add_ sums each row in slot
           order, as the kernel does), cbl_stats_fwd counts exact, sums rel
           <= 1e-5 and the same bits on every lane when run again,
           cbl_stats_bwd max-abs <= 1e-4 of the output's
           scale, the same bits when run again, and its first pass's slot
           coefficients cd within 1e-5 of their scale of the plain
           version's; the same on one step over integer-grid clouds. Then
           each call timed as in phase 4 (5 runs each), and the largest
           (level-0) window_topk, window_gather, window_gather_bwd,
           cbl_stats_fwd and cbl_stats_bwd calls 20 times through the wrapper
           and through the bare C entry.
10. stale-train phase 8 with bn_mode='stale': pt_attn_fwd and pt_attn_bwd
           exactly 18 launches each, window_gather and window_gather_bwd 18
           fewer than in phase 8 (the attention layers' gathers are inside
           the kernel), the same kernel-vs-plain, five-step, timing, memory
           and profile checks.
11. stale-kernels every pt_attn call of that step against its plain version
           (out, both statistic pairs, dq, dkv and each of the 12 parameter
           gradients within 1e-4 of scale; the forward's out, s1 and s2 the
           same bits when run again), and of one stale step on integer-grid
           clouds, whose backward calls also give dkv exactly on integer
           cotangents (with W4 = 0, so that the softmax weights are exact);
           then each call timed as in phase 4 (5 runs each), both kernels'
           times summed per width (C, M, K, launches, ms, bound), and the
           largest (level-0) call of each 20 times through the wrapper and
           through the bare C entry.

12. cbl-xla the flagship train step of phase 8 with CBL_DENSE=off and
           ContrastConfig(impl='xla'), the reference's XLA tile route: the
           label pack and the latents gathered by window_gather (its backward
           by window_gather_bwd), exactly 5 more launches of each than phase
           8 (one a stage) and none of a CBL kernel; kernel vs plain step,
           five steps, step time, memory and profile as in phase 8.
13. cbl-pallas the same with impl='pallas', the fused v2 kernel:
           cbl_tile2_fwd and cbl_tile2_bwd exactly 5 launches each (the
           backward reads the forward's statistics), the dense CBL kernels
           none, the gathers as in phase 8; the same step checks; and the CBL
           losses of one step of phases 8 and 13 against phase 12's on the
           same weights and batch, each stage within the tolerance the CPU
           tests state (dense 3e-5, v2 1e-5).
14. cbl-kernels every v2 call of phase 13's step against its plain version
           and timed: the forward's counts and mask exact on every row,
           lanes 0-2 and loss·mask within 1e-4 of scale on the rows of the
           mask and the fill (0, 0, 0; loss·mask 0) elsewhere, the same bits
           when run again; the backward within 1e-4 of scale, the same bits
           when run again, its pass-1 coefficients within 1e-5 of scale; the
           level-0 calls also 20 times alone for the spread of a launch's
           time, with the backward scatter's terms a support tile; v1
           (cbl_tile_fwd, cbl_tile_bwd), which no path runs,
           at that step's level-0 shape ([soft labels | latents], K = 35)
           against its plain version as v2 is held (the backward's label
           columns zero and its feature columns v2's backward bit for bit
           on v1's split with v1's statistics) and against v2 on the same
           inputs, its level-0 calls also 20 times alone;
           gather_rows, which no path runs either, equal to x[idx] at x
           [131072, 128] f32 with 131072 random rows, timed beside
           torch.index_select.
15. plan-shapes direct calls at shapes the reference trains beyond the
           flagship's, whose plans take smaller tiles or slot chunks, on
           seeded inputs: pt_attn_fwd and pt_attn_bwd at C = 512 with K = 8
           (M = 1024) and K = 32 and 48 (M = 256), held as in phase 11; and
           cbl_stats_fwd on windows wider than shared memory holds (width 7
           x tile 256 and width 3 x tile 1024, K = 36), read through L2 and
           held as in phase 9, with the L2 path at the flagship's level-0
           window equal bit for bit to the staged path; and cbl_tile2_fwd and
           cbl_tile2_bwd at every shape class the previous v2 kernels took
           (V2_SHAPES: C in {1, 20, 32, 33, 64, 128}, K in {1, 35, 300},
           M·K >= 2^23, tile x width 128 x 5 and 1024 x 1, every row and no
           row in the loss mask) held as in phase 14; and v1 at V1_SHAPES
           (C in {1, 32, 33, 128}, ncls in {1, 13, 40} with ties among the
           label columns, K in {1, 35}) held as in phase 14.
16. bf16-serve the checkpoint in PointTransformerSeg(dtype=bfloat16), batch
           BN, on phase serve's crops: one request with the counts reset
           (window_gather launched on bfloat16 rows), the running statistics
           untouched, probs against the plain versions' within half of the
           bf16-vs-f32 probs gap from the same weights (phase serve's probs;
           printed as the scale beside it), argmax agreement >= 99.5%, crop
           OA >= 0.5, the median of 3 warm requests and the peak memory
           beside phase serve's, one voting request.
17. bf16-train phase 8 with the bf16 model: the launches by dtype (window_gather
           18 bfloat16 and 21 float32, window_gather_bwd 18 bfloat16 and 12
           float32: the attention layers' kv rows are bfloat16, the other
           gathers' inputs come out of a BN), kernel vs plain step (loss rel
           <= 1e-3, gradient norm rel <= 1e-2, running statistics rel <=
           1e-2) with the bf16-vs-f32 step gap from the same weights (phase
           8's step) printed beside them, five steps that lower the loss, the
           step median, peak memory and busy share beside phase 8's and
           PERF.md's f32 numbers.
18. bf16-stale phases 7 and 10 with the bf16 model under bn_mode='stale': a
           request (pt_attn_fwd 18 bfloat16 launches, the same probs, OA and
           timing checks as phase 16 against phase serve's probs, one voting
           request) and the train step (pt_attn_fwd and pt_attn_bwd 18
           bfloat16 launches each, the checks of phase 17 against phase 10's
           step).
19. bf16-kernels the four bfloat16 kernel instances on the recorded calls of
           phases 17 (the gathers) and 18 (the attention) against their plain
           versions: window_gather bit for bit; window_gather_bwd within one
           bfloat16 ulp of the plain version's float32 sum, exact on integer
           cotangents, the same bits when run again and the plain version's
           CPU sum rounded once bit for bit; pt_attn_fwd and pt_attn_bwd out,
           dq and dkv within one bfloat16 ulp plus 1e-4 of scale, the
           statistics and the 12 gradients within 1e-4 of scale, the forward
           the same bits twice; each timed as in phase 4, with the bound from
           the bfloat16 bytes and the library calls x[b, rows] and a float32
           index_add_ of g.float() then .to(bfloat16); and each call beside
           its float32 twin (the operands widened) in turns, summed.
20. eval-features the checkpoint through make_eval_step(output='logits',
           with_features=True) on phase serve's crops: one request with the
           counts reset (window_topk and window_gather launched as in phase
           serve), softmax(logits) within 1e-6 of phase serve's probs with the
           same argmax, each stage's latent [B, N, d] finite in the caller's
           row order, the logits and every latent within 1e-3 of their scale
           of the plain versions'; the same for one stale-BN request against
           phase stale-serve (pt_attn_fwd exactly 18).
21. voting-features run_voting_eval over synthetic val room 0 (71,303 points
           after voxelization) with the feature step, num_votes 1.0, at most
           40 requests (requests, final minimum potential, sub and full mIoU
           and OA), then run_boundary_suite with 'boundary-stat-feature' on
           the voted cloud: B-IoU finite in [0, 1], every latent's l2, cos and
           norml2 distances finite, pct_err_on_bound_label printed.
22. enumerate run_enumerate_eval over room 0 (n_points 65536, voxel_max
           80000, B=2 crops a request, 'boundary-stat'): every point covered,
           full OA >= 0.5 with the trained checkpoint; passes, parts,
           requests, the eval step's median ms a request on the host clock,
           the room's seconds split into the eval step (to a synchronize) and
           the host's numpy and copies, B-IoU. Phases 20-26 print the card's
           name and power limit.
23. bf16-eval-features phase 20 with the checkpoint in the bfloat16 model,
           under batch and stale BN, on phase serve's crops: the launches and
           the launches by dtype those of phase bf16-serve's and bf16-stale's
           requests, softmax(logits) equal to their probs (max |d| 0) with the
           same argmax, every latent finite, and the RMS of its difference
           from the plain versions' at most half the RMS of its
           bfloat16-vs-float32 gap (phase 20's latents, the same weights) or
           twice the RMS by which the plain version's latents move when the
           fused attention sums its slots in reverse order (sum order alone).
24. train-entry the flagship trained through the port's entry point,
           main.py's main(["-c", "s3dis_pt_cbl", "--mode", "train", ...]):
           4 synthetic train rooms (Area_1) and 1 val room (Area_5) of
           120,000 points written as S3DIS xyzrgbl .npy files in a temporary
           directory; full width and depth from the flax-like init,
           default_train_transform, prefetch depth 3; cut to batch 2 (from
           16), 1 epoch (from 200) and loop 2 (from 30): 4 steps, then the
           epoch-end voting eval (num_votes 1.0, 4 crops a request) and the
           snapshot; log_freq 1 reads every step's loss. The phase wraps
           main.py's prefetch (StepProbe: utils/profiling.py::StepTimer, the
           wait for each batch, each step ended by a synchronize, the
           launches each step made): every loss finite (read back with
           read_scalars), each step's launches equal to phase 8's, every
           kernel of the path launched in the run, snap-4 and best.json
           written; the wait, step median, points/s and peak memory; the
           same run with the iterator in the loop's thread (no eval
           request); then main(["--mode", "val", "--model_path", "auto"])
           on the run: the restored parameters, buffers and momentum equal
           the live model's bit for bit, and its probs on phase serve's
           batch within 1e-6 of the live model's.
25. train-entry-bf16 two steps of s3dis_pt_cbl_bf16 through main.py (no
           eval request: num_votes 0): losses finite, each step's gathers
           by dtype 18 bfloat16 + 21 float32 and backward 18 + 12 (phase
           17's).
26. prepare-test ScanNet's offline path through main.py: three raw scenes
           (data/synthetic.py::write_scannet_scene: 6 x 6 x 3 m rooms, a
           floor, four walls and six boxes as binary ply meshes with faces,
           raw label ids of the benchmark, one box and 2% of the vertices
           with ignored ids) converted by prepare_scannet (rasterized at
           2000 points/m^2: ~250,000 points a scene); --mode calibrate
           (data.n_points logged); --mode train on scannet_pt_cbl at full
           width (20 classes, N = 65536, voxel_max 80000; the sorted layout
           and strided sampler; batch 2, loop 2: 3 steps, no eval request),
           each step's launches equal to phase 8's, losses finite; --mode
           test --model_path auto on the same scenes with the preset's 2.0
           votes: each request's launches equal to phase serve's, the first
           request's probs against the plain versions' on the same weights
           (1e-3, argmax >= 99.9%), and each scene's <scene>_pred.npy one
           class in 0-19 for each prepared point.
27. conv-train the ConvNet family, which runs no kernel of the port (the
           reference computes it in XLA): s3dis_conv_cbl at full width
           (base_fdim 72, strides 1-4-4-4-4, neighbour caps 26-31-38-41-39,
           radii 0.1·2^l, contrast 36-24-24-24-24, 13 classes) from fresh
           weights (seed 0) with the preset's optimizer (SGD m 0.98, lr
           0.02, decay 1e-3, clip 100), on B = 8 (the preset's; halved while
           it does not fit) x N = 65536 synthetic train crops: the natural
           pyramid on the card against the CPU's on one 8,192-point crop on
           the 1/64 m grid (every index equal, up_w within 1e-6); one step
           on that crop on the card against the CPU from the same weights
           (loss rel <= 1e-4, gradient norm rel <= 1e-3); five steps at full
           size lowering the loss, the median of the 3 warm ones, peak
           memory, one profiled step (device time, busy share, top device
           ops) and the device time of the training pyramid alone; one step
           each of s3dis_conv_cbl_kl, s3dis_pospool_cbl and
           s3dis_pseudogrid_cbl on the first 2 of those crops (losses
           finite; the batch cut 8 -> 2 keeps the script in its time as
           phases 33-34 join it); every launch count of the port's kernels
           0 through all of it.
28. conv-serve the eval step of that model on those crops: probs finite, the
           request median and peak memory, one profiled request; on the
           8,192-point crop the card's probs against the CPU's (1e-4,
           argmax >= 99.9%); launch counts 0.
29. conv-entry scannet_conv_cbl through main.py on phase 26's prepared
           scenes: --mode calibrate, whose neighbour caps are fed back
           through --set; --mode train at full width with phase 26's cuts
           (batch 2, epochs 1, loop 2: 3 steps, no eval request), losses
           finite; --mode test --model_path auto with the preset's votes,
           every request's probs finite and each scene's predictions one
           class in 0-19 a point; launch counts 0.
30. pt-natural-train the point transformer on the natural layout, whose
           only kernel of the port is the FPS chain (csrc/fps.cu):
           s3dis_pt_cbl_paper at full width (planes 32-512, blocks
           2-3-4-6-3, contrast 36-24-24-24-24, sub-scene searches, bucketed
           FPS in 64 buckets) from the checkpoint (the same parameter tree;
           fresh weights from seed 0 without it), SGD lr 0.05, on B = 2 (cut
           from 16) x N = 65536 synthetic train crops: the natural pyramid
           on the card against the CPU's on one 8,192-point crop on the
           1/64 m grid (every index equal, up_w, self_rel and down_rel within
           1e-6) and one step on it (loss rel <= 1e-4, gradient norm rel <=
           1e-3); one step with the counts reset just before and read just
           after: fps launched once a sampled level (4), every other kernel
           and wide search 0; five steps lowering the loss, the median of the
           3 warm ones, peak memory, one profiled step (busy share, top
           device ops), the training pyramid's device time; one stale-BN
           step (the unfused attention, as the reference's): fps 4, every
           other kernel 0; then every fps call of the step and of the grid
           crop's pyramid, and one exact FPS of 65536 -> 16384 rows on one
           cloud, against the plain version (the same picks), the step's
           calls and the exact one timed beside their bound and chain steps.
31. pt-natural-serve the eval step of that model at the preset's eval batch
           (B = 4 x 65536): fps 4 launches a request and nothing else, the
           request median and peak memory, one profiled request; on the
           8,192-point crop the card's probs against the CPU's (1e-4, argmax
           >= 99.9%).
32. pt-natural-entry main.py -c s3dis_pt_cbl_paper --mode train on phase
           24's rooms with its cuts (batch 2, epochs 1, loop 2: 4 steps,
           num_votes 20 -> 1 for the epoch-end eval), then --mode val; and
           main.py -c scannet_pt_cbl --mode train as published (the natural
           layout) on phase 26's scenes with its cuts (3 steps): the natural
           spec built, losses finite, each step's launches fps 4 and nothing
           else.
33. dp-gloo data parallel (parallel/) over two ranks of a gloo group on the
           one card (NCCL refuses two ranks on one device), each a process
           of this script (--dp-rank) taking one crop of 65536 points of
           B = 2: two batch-BN flagship steps (the dense CBL route) and one
           stale-BN step from the checkpoint; then, from rank 0's state
           before each, the world-size-1 kernel step on both crops here.
           Loss and metrics rtol 2e-4, the confusion's rows exact (at most
           0.1% of points moved elsewhere), parameters within 1e-2 of the
           update, running statistics elementwise to rtol 1e-5 plus 1e-5
           of each statistic's RMS (the CPU tests' tolerances), every rank's state bit for bit rank 0's, every
           rank's kernel launches the world-size-1 step's, its collectives
           all-reduces only (calls and bytes printed; each rank's step time
           is a check, not a figure).
34. dp-nccl an NCCL group over the visible cards (at most 4; one on a
           one-card machine) and one all-reduce (--nccl-rank); then python
           -m contrastboundary_tpu_torch.main -c s3dis_pt_cbl --mode train
           on phase 24's rooms, one process a card under CBL_COORDINATOR,
           CBL_NUM_PROCESSES and CBL_PROCESS_ID (one epoch, batch a multiple
           of the world size, 0.1 votes): losses finite, the snapshot
           written, and at world size 1 no collective in its steps (the
           log's count); on 2-4 cards the comparison of phase 33 under
           NCCL, a crop a card.
35. pt-base-train the point-transformer baseline without CBL, s3dis_pt (the
           sorted layout, the plain mlp head: cls_tower, cls), at full width
           (planes 32-512, blocks 2-3-4-6-3) from random_flax_tree (seed 0),
           the preset's SGD (lr 0.5, momentum 0.9, decay 1e-4), on B = 2
           (cut from 16) x N = 65536 synthetic train crops: one batch-BN
           step with the counts reset just before and read just after
           (window_topk, window_gather and window_gather_bwd launched, every
           CBL kernel, pt_attn and fps 0) and one stale-BN step (pt_attn_fwd
           and pt_attn_bwd 18 each, the gathers 18 fewer), each against the
           plain versions' step from the same weights and batch at phase
           8's limits (loss rel 1e-4, gradient norm 1e-3, running
           statistics 1e-4); before those, the batch-BN median of 3 warm
           steps, points/s and peak memory, and 3 stale steps and their
           peak, every timed step from the same weights (losses finite);
           then every kernel
           call of both steps against its plain version (as phase 9 holds
           it) and timed (3 runs each), summed into the JSON line's
           "s3dis_pt/<kernel>" entries.
36. pt-base-serve the eval step of that model on phase serve's crops:
           window_topk and window_gather launched and nothing else, the
           median of 3 requests and the peak memory, the probs against the
           plain versions' (1e-3, argmax >= 99.9%); then one train step of
           s3dis_pt with the plain head 'mlp-1-xen-dp.5' from the same
           weights: its dropout mask, drawn on the card from the trainer's
           step-0 key (utils/threefry.py), equal bit for bit to the mask the
           CPU draws from that key.
37. randla-train the RandLA-style ConvNet+CBL s3dis_randla_cbl (the random
           sampler: each level the first rows of a fixed threefry
           permutation) at full width from fresh weights (seed 0), the
           preset's SGD (lr 0.02, momentum 0.98, clip 100), B = 8 (the
           preset's; halved while it does not fit, as phase 27's) x N =
           65536: its natural pyramid on the card against
           the CPU's on phase 27's grid crop (the random picks and every
           search equal), a warm-up step, three steps that lower the loss
           (median, peak memory), one request; no kernel of the port
           launched.
38. pt-base-entry main.py -c s3dis_pt --mode train on phase 24's rooms with
           its cuts (batch 16 -> 2, epochs 1, loop 2: 4 steps, num_votes 1),
           each step's launches phase 35's batch-BN step's, losses finite;
           then --mode val on the run (window_topk and window_gather only).
39. randla-entry the same for s3dis_randla_cbl (batch 8 -> 2), no kernel
           of the port launched.
40. windowed-kernels ops/knn.py::windowed_knn (knn_window 3, tiles of 256)
           at the level shapes of s3dis_pt_cbl_paper's training pyramid
           and s3dis_conv_cbl's radius searches, B = 2 x 65536 crops on the
           1/64 m grid: self (ensure_self), contrast (exclude_self), down,
           up, near0 under both top-1 tie rules, sub-scene; the ConvNet's
           self and down searches within their radii. Each with the kernel
           and with the plain version: indices and d2 equal bit for bit, its
           window_topk launch exact; the launch alone, the whole windowed
           search and the dense knn of the same query timed (L2 flushed,
           mean of 5) beside the launch's bound.
41. pt-natural-windowed-train s3dis_pt_cbl_paper with model.knn_window:3
           and model.contrast_mode:tile from the checkpoint, B = 2 x 65536 on
           phase 30's crops: the natural pyramid on the card against the
           CPU's on a grid crop (every index and the tile contrast search's
           Morton orders equal), one step card vs CPU; 5 steps that lower
           the loss (median, peak, the pyramid's device time beside phase
           30's), one profiled; one step with the counts reset: exactly
           window_topk 26, cbl_stats_fwd 5, cbl_stats_bwd 5, fps 4 and no
           wide search; kernel vs plain step at phase 8's limits; each
           call against its plain version and timed (3 runs).
42. pt-natural-windowed-serve its eval step at the preset's B = 4:
           window_topk 17 and fps 4 a request, the median of 3 beside phase
           31's, probs within 1e-4 of the plain versions'; then main.py -c
           s3dis_pt_cbl_paper --mode train with both --sets on phase 24's
           rooms (loop 1: 2 steps, no epoch-end eval), each step's launches
           those of phase 41.
43. conv-windowed-train s3dis_conv_cbl with model.knn_window:3, fresh
           weights: its pyramid on the card against the CPU's on phase 27's
           grid crop, one step card vs CPU at phase 27's limits; B = 8
           (halved while it does not fit): 5 steps that lower the loss,
           median, peak and the pyramid's device time beside phase 27's;
           exactly 26 window_topk launches a step and no other kernel; each
           call against its plain version and timed (3 runs).
44. contrast-window-train the sorted flagship s3dis_pt_cbl with
           model.contrast_window:2 as phase 8 runs it (the self search and
           a contrast search of 5 tiles, 1,280 rows, apart): window_topk 23
           a step (18 + 5), the CBL kernels at width 5; kernel vs plain step;
           the window top-k and CBL calls against their plain versions and
           timed (5 runs).
45. cbl-width-kernels the CBL kernels at the widths the CBL head's options
           give them, on phase 8's pyramid (the flagship's contrast
           neighbours and sub-scene labels of its batch) with seeded
           random features: cbl_stats_fwd and cbl_stats_bwd at C in {13,
           20} (levels 0 and 4) and 32, 64, 128, 256, 512 (level i at
           planes[i], as f_out gives them), each against its plain version
           as phase 9 holds it (counts exact, the sums rel 1e-5, the
           backward 1e-4 of scale, its pass-1 coefficients 1e-5, the same
           bits twice); cbl_tile2_fwd and cbl_tile2_bwd at C in {13, 256,
           512} (levels 0, 3, 4) as phase 14 holds them; window_gather and
           window_gather_bwd at the fused [labels | features] widths of the
           plain route (26, 34 with the nn4 prefix, 45 at level 0; 514 at
           level 4) as phase 9 holds them; each call timed (L2 flushed,
           mean of 5) beside its bound, into "cbl_width/<kernel>@C<c>"
           (launches: the kernel's at that width in one recorded step of
           phase 46 or 47, the most of those steps, 0 where none runs it;
           the direct calls under "direct_launches").
46. cbl-fout-train the sorted flagship with arch_out 'multi-Ua-concat-
           latent|contrast-Ua-softnn-fout-label-l2-w.1' (the CBL on each
           level's decoder features) from the checkpoint, as phase 8 runs
           it: exactly 5 cbl_stats_fwd and 5 cbl_stats_bwd launches a step,
           at C = 32, 64, 128, 256, 512, the gathers and top-k as phase 8's;
           5 steps that lower the loss, the median and the peak; kernel vs
           plain step at phase 8's limits; each CBL call against its plain
           version and timed (3 runs); then one step with CBL_DENSE=off and
           impl='pallas': exactly 5 + 5 cbl_tile2 launches at those widths,
           kernel vs plain step, its calls timed; "cbl_fout/<kernel>".
47. cbl-options-train two option strings over the flagship, fresh weights:
           (a) 'multi-Ua-concat-latent-sep|contrast-Ua-nce-latent-
           label_recur-l2square-mS-mask-nn4-rand8-projmlp-w.1', (b)
           'multi-Ua-concat-latent|contrast-Ua-softnn-probs-labelkl.5-nst-
           kl-p2-w.1', each on phase 8's batch: 3 steps that lower the
           loss, metrics finite; one step with the counts reset: no CBL
           kernel, window_gather and window_gather_bwd 5 more than phase
           8's (the plain route's fused gather a stage); kernel vs plain
           step at phase 8's limits; the 5 fused gathers and their
           backwards timed (3 runs) into "cbl_options/a/<kernel>" and
           "cbl_options/b/<kernel>". Then
           main.py -c s3dis_pt_cbl --mode train with (a) through --set on
           phase 24's rooms (loop 1: 2 steps, no epoch-end eval), losses
           finite, no CBL kernel launched, and --mode val on that run (the
           weights restored bit for bit, 0.3 votes).

It prints the card's name and power limit, one JSON line of per-kernel
numbers (times are sums over the launches of one run of a path: the numbers
of the kernels a request runs, window_topk, window_gather and pt_attn_fwd,
are per serving request, with those of one train step under "train"; the
training kernels' numbers are per train step; v1 and gather_rows, which
no path runs, have the launches read from phase 13's step, which must be
0 as in every train run, and their direct calls under "direct_launches"),
the bfloat16 instances as entries of their own, per train step (the
gathers of phase 17's step, the attention of phase 18's), and the FPS
kernel per natural train step (phase 30's; its exact call under "exact"),
the s3dis_pt step's kernels per s3dis_pt train step (phase 35's: the
gathers and the top-k of its batch-BN step, the attention of its stale
step) as entries named "s3dis_pt/<kernel>", the kernels of the option
paths per step of phases 41, 43 and 44 as "pt_natural_windowed/<kernel>",
"conv_windowed/<kernel>" and "contrast_window/<kernel>", the CBL head's
options of phases 45-47 as "cbl_width/<kernel>@C<c>", "cbl_fout/<kernel>"
and "cbl_options/<a or b>/<kernel>", and as its last
line {"ok": true, "device": {...}}. Without CUDA it exits with 2 before
doing anything.
"""
from __future__ import annotations

import ast
import copy
import ctypes
import dataclasses
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from contextlib import ExitStack, contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from contrastboundary_tpu_torch import main as entry
from contrastboundary_tpu_torch import parallel
from contrastboundary_tpu_torch.config import load_config
from contrastboundary_tpu_torch.core.gather import batch_gather
from contrastboundary_tpu_torch.data.prepare_scannet import prepare_scannet
from contrastboundary_tpu_torch.data.synthetic import (
    SyntheticSceneDataset, train_batch, write_scannet_scene,
)
from contrastboundary_tpu_torch.eval.run import (
    run_boundary_suite, run_enumerate_eval, run_voting_eval,
)
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.eval.voting import VotingEvaluator
from contrastboundary_tpu_torch.kernels import build
from contrastboundary_tpu_torch.models import (
    PointTransformerSeg, load_checkpoint, load_jax_variables,
)
from contrastboundary_tpu_torch.models import blocks as model_blocks
from contrastboundary_tpu_torch.losses import ContrastConfig
from contrastboundary_tpu_torch.losses import contrast as cbl_losses
from contrastboundary_tpu_torch.ops import PyramidSpec, build_pyramid, knn, sampling
from contrastboundary_tpu_torch.ops.cuda import cbl_dense as cd
from contrastboundary_tpu_torch.ops.cuda import cbl_tile as c1
from contrastboundary_tpu_torch.ops.cuda import cbl_tile2 as c2
from contrastboundary_tpu_torch.ops.cuda import fps as fpk
from contrastboundary_tpu_torch.ops.cuda import gather_dma as gd
from contrastboundary_tpu_torch.ops.cuda import pt_attn as pa
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg
from contrastboundary_tpu_torch.ops.cuda import win_topk as wt
from contrastboundary_tpu_torch.ops.tile_gather import window_starts
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step
from contrastboundary_tpu_torch.train.trainer import dropout_key
from contrastboundary_tpu_torch.utils import StepTimer, read_scalars

# main.py's own prefetch, setup and eval step, which phases 24-26 wrap
entry_prefetch, entry_setup, entry_eval_step = entry.prefetch, entry.setup, entry.make_eval_step
ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "results" / "ckpts" / "parity_s0_fast_e15.pkl"
B, N, NUM_CLASSES = 2, 65536, 13
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, CUDA cores, no tensor cores
KERNELS = {
    "window_topk": dict(
        source="contrastboundary_tpu_torch/csrc/win_topk.cu",
        replaces="contrastboundary_tpu/ops/pallas/win_topk.py:157",
    ),
    "window_gather": dict(
        source="contrastboundary_tpu_torch/csrc/tile_gather.cu",
        replaces="contrastboundary_tpu/ops/pallas/tile_gather_pl.py:120",
    ),
    "window_gather_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/window_gather_bwd.cu",
        replaces="contrastboundary_tpu/ops/pallas/tile_gather_pl.py:156",
    ),
    "cbl_stats_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_dense.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_dense.py:247",
    ),
    "cbl_stats_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_dense.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_dense.py:272",
    ),
    "pt_attn_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/pt_attn.cu",
        replaces="contrastboundary_tpu/ops/pallas/pt_attn.py:406",
    ),
    "pt_attn_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/pt_attn.cu",
        replaces="contrastboundary_tpu/ops/pallas/pt_attn.py:830",
    ),
    "cbl_tile2_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile2.py:317",
    ),
    "cbl_tile2_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile2.py:350",
    ),
    "cbl_tile_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile.py:233",
    ),
    "cbl_tile_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile.py:259",
    ),
    "gather_rows": dict(
        source="contrastboundary_tpu_torch/csrc/gather_rows.cu",
        replaces="contrastboundary_tpu/ops/pallas/gather_dma.py:52",
    ),
    # the port's own kernel: the reference's FPS chain is a lax.fori_loop
    # (no pallas_call)
    "fps": dict(
        source="contrastboundary_tpu_torch/csrc/fps.cu",
        replaces="contrastboundary_tpu/ops/sampling.py:54",
    ),
    # the bfloat16 instances: the same C entries on bfloat16 operands
    "window_gather_bf16": dict(
        source="contrastboundary_tpu_torch/csrc/tile_gather.cu",
        replaces="contrastboundary_tpu/ops/pallas/tile_gather_pl.py:124",
    ),
    "window_gather_bwd_bf16": dict(
        source="contrastboundary_tpu_torch/csrc/window_gather_bwd.cu",
        replaces="contrastboundary_tpu/ops/pallas/tile_gather_pl.py:156",
    ),
    "pt_attn_fwd_bf16": dict(
        source="contrastboundary_tpu_torch/csrc/pt_attn.cu",
        replaces="contrastboundary_tpu/ops/pallas/pt_attn.py:406",
    ),
    "pt_attn_bwd_bf16": dict(
        source="contrastboundary_tpu_torch/csrc/pt_attn.cu",
        replaces="contrastboundary_tpu/ops/pallas/pt_attn.py:830",
    ),
}
BF16 = torch.bfloat16
# each bfloat16 instance's kernel (wrapper, plain version, C entry)
BF16_KERNELS = {"window_gather_bf16": "window_gather",
                "window_gather_bwd_bf16": "window_gather_bwd",
                "pt_attn_fwd_bf16": "pt_attn_fwd", "pt_attn_bwd_bf16": "pt_attn_bwd"}
# the float32 batch-BN step's numbers recorded in PERF.md section 5 (NVIDIA
# H100 80GB HBM3, 700.00 W)
F32_STEP_PERF = "8.25 GB, 241.063 ms"
# each kernel's wrapper (module, attribute) and its plain version
WRAPPERS = {
    "window_topk": (wt, "window_topk", wt.window_topk_plain),
    "window_gather": (tg, "window_gather", tg.window_gather_plain),
    "window_gather_bwd": (tg, "window_gather_bwd", tg.window_gather_bwd_plain),
    "cbl_stats_fwd": (cd, "cbl_stats_fwd", cd.cbl_stats_fwd_plain),
    "cbl_stats_bwd": (cd, "cbl_stats_bwd", cd.cbl_stats_bwd_plain),
    "pt_attn_fwd": (pa, "pt_attn_fwd", pa.pt_attn_plain),
    "pt_attn_bwd": (pa, "pt_attn_bwd", pa.pt_attn_bwd_plain),
    "cbl_tile2_fwd": (c2, "cbl_tile2_fwd", c2.cbl_tile2_fwd_plain),
    "cbl_tile2_bwd": (c2, "cbl_tile2_bwd", c2.cbl_tile2_bwd_plain),
    "cbl_tile_fwd": (c1, "cbl_tile_fwd", c1.cbl_tile_fwd_plain),
    "cbl_tile_bwd": (c1, "cbl_tile_bwd", c1.cbl_tile_bwd_plain),
    "gather_rows": (gd, "gather_rows", gd.gather_rows_plain),
    "fps": (fpk, "fps_chains", fpk.fps_chains_plain),
}
SERVE_KERNELS = ("window_topk", "window_gather")
PATH_KERNELS = ("window_topk", "window_gather", "window_gather_bwd")
# the train step's CBL routes (losses/contrast.py): CBL_DENSE, ContrastConfig.impl
# and the CBL kernels each launches (the XLA tile route only adds gathers)
CBL_ROUTES = {
    "dense": (None, "xla", ("cbl_stats_fwd", "cbl_stats_bwd")),
    "xla": ("off", "xla", ()),
    "pallas": ("off", "pallas", ("cbl_tile2_fwd", "cbl_tile2_bwd")),
}
CBL_KERNELS = ("cbl_stats_fwd", "cbl_stats_bwd", "cbl_tile2_fwd", "cbl_tile2_bwd")
# kernels no path runs (as in the reference): every train run reads 0 of them
NO_PATH_KERNELS = ("cbl_tile_fwd", "cbl_tile_bwd", "gather_rows")
TRAIN_KERNELS = PATH_KERNELS + CBL_ROUTES["dense"][2]
STALE_SERVE_KERNELS = SERVE_KERNELS + ("pt_attn_fwd",)
STAGES = 5  # CBL stages of the flagship, one launch of each CBL kernel a stage
# the tolerances the CPU tests state between the routes' stage losses:
# dense against the XLA tile route (tests/test_torch_cbl.py), v2 against it
# (tests/test_torch_cbl_routes.py)
ROUTE_RTOL = {"dense": 3e-5, "pallas": 1e-5}
# attention layers of the flagship: 13 encoder blocks (blocks (2, 3, 4, 6, 3)
# less one transition a level) and 5 decoder blocks
ATTENTION_LAYERS = 18
TRAIN_SPEC = PyramidSpec(k_contrast=(36, 24, 24, 24, 24), with_subscene=True)
TRAIN_LR = 0.05
# phase 24's dataset and --set cuts (batch 16 -> 2, epochs 200 -> 1, loop
# 30 -> 2) and its instrumentation (every step's loss read and recorded)
ENTRY_ROOMS, ENTRY_POINTS = 4, 120_000
ENTRY_SETS = "optim.batch_size:2;optim.epochs:1;data.loop:2;eval.num_votes:1.0"
ENTRY_LOG = "log_freq:1"
# phase 26: raw ScanNet scenes of write_scannet_scene's default room (6 x 6 x
# 3 m) and the --set cuts of scannet_pt_cbl (the port's sorted layout and
# strided sampler; batch 16 -> 2, epochs 200 -> 1, loop 30 -> 2: 3 steps)
SCANNET_SCENES = 3
SCANNET_CUTS = "optim.batch_size:2;optim.epochs:1;data.loop:2"
SCANNET_SETS = f"model.layout:sorted;model.sampler:strided;{SCANNET_CUTS}"
SCANNET_CLASSES = 20
# gathers of a batch-BN bf16 step by dtype: the attention layers' kv rows are
# bfloat16; TransitionDown's [p | x], TransitionUp's and the head's rows and
# the training pyramid's and CBL's gathers come out of a BN or are float32
# phases 27-29: the ConvNet family at full width (no kernel of the port runs)
CONV_PRESETS = ("s3dis_conv_cbl", "s3dis_conv_cbl_kl", "s3dis_pospool_cbl",
                "s3dis_pseudogrid_cbl")
CONV_B, CONV_GRID_N = 8, 8192
CONV_ENTRY = "scannet_conv_cbl"
# phases 30-32: the point transformer on the natural layout (bucket_fps), at
# full width, the batch cut 16 -> B as every point-transformer phase
PT_NATURAL, PT_NATURAL_SCANNET = "s3dis_pt_cbl_paper", "scannet_pt_cbl"
# phases 35-39: the point-transformer baseline without CBL (the plain mlp
# head; one step of it with dropout) and the RandLA-style ConvNet+CBL (the
# random sampler)
PT_BASE, PT_BASE_DROPOUT, RANDLA = "s3dis_pt", "arch_out:mlp-1-xen-dp.5", "s3dis_randla_cbl"
# phases 40-44: the pyramid options. The natural point transformer with the
# windowed KNN and the tile contrast search (and the launches predicted for
# its step and its request at B x N: levels of 65536 .. 256 rows, each a
# multiple of the tile of 256, so every search is a window search: 5 self, 4
# down, 4 up, 4 near0, 4 sub-scene and 5 tile contrast searches a step, the
# CBL's 5 stages on the dense-window kernels, fps on the 4 sampled levels);
# the ConvNet with the windowed KNN (the same 26 searches, the contrast ones
# windowed global searches); the sorted flagship with a contrast window of
# its own (its 18 searches and 5 contrast searches of width 5 tiles)
PT_WINDOWED = "model.knn_window:3;model.contrast_mode:tile"
PT_WINDOWED_STEP = {"window_topk": 26, "cbl_stats_fwd": 5, "cbl_stats_bwd": 5, "fps": 4}
PT_WINDOWED_REQUEST = {"window_topk": 17, "fps": 4}
CONV_WINDOWED = "model.knn_window:3"
CONV_WINDOWED_STEP = {"window_topk": 26}
PT_FLAGSHIP, CONTRAST_WINDOW, CONTRAST_WINDOW_TOPK = "s3dis_pt_cbl", "model.contrast_window:2", 23
# phases 45-47: the CBL head's options over the sorted flagship. The widths
# the dense and v2 CBL kernels take there, each with the flagship levels of
# phase 8's pyramid it runs on (f_out: level i at planes[i]; logits or
# probs: the class count, 13 on S3DIS and 20 on ScanNet); the fused
# [labels | features] widths of the plain route's window gathers (kl
# positives over probs 13 + 13, cnt over the latents 2 + 32 with the nn4
# prefix, kl positives over the latents 13 + 32, cnt over f_out at level 4
# 2 + 512) as (width, level, nn prefix slots); the option strings of phases
# 46 and 47
PLANES = (32, 64, 128, 256, 512)
DENSE_WIDTH_LEVELS = {13: (0, 4), 20: (0, 4), 32: (0,), 64: (1,), 128: (2,), 256: (3,),
                      512: (4,)}
V2_WIDTH_LEVELS = {13: (0,), 256: (3,), 512: (4,)}
FUSED_GATHERS = ((26, 0, 0), (34, 0, 4), (45, 0, 0), (514, 4, 0))
FOUT_HEADS = "multi-Ua-concat-latent|contrast-Ua-softnn-fout-label-l2-w.1"
OPTION_HEADS = (
    "multi-Ua-concat-latent-sep|contrast-Ua-nce-latent-label_recur-l2square-mS-mask-nn4-rand8-"
    "projmlp-w.1",
    "multi-Ua-concat-latent|contrast-Ua-softnn-probs-labelkl.5-nst-kl-p2-w.1",
)
# phases 33-34: data parallel (parallel/); the seeds of the global batches
# of the rank-vs-world-size-1 steps, and the most cards dp-nccl groups
DP_SEEDS = {"batch": (0, 1), "stale": (0,)}
DP_MAX_WORLD = 4
BF16_STEP_GATHERS = {"window_gather": {"bfloat16": ATTENTION_LAYERS, "float32": 21},
                     "window_gather_bwd": {"bfloat16": ATTENTION_LAYERS, "float32": 12}}


def base(name: str) -> str:
    """The kernel an entry of KERNELS runs (a bfloat16 instance's kernel)."""
    return BF16_KERNELS.get(name, name)


def split_bf16(calls: dict) -> dict:
    """Recorded calls with each kernel's bfloat16 calls (of its first
    operand: x, g or q) moved to its bfloat16 instance's entry."""
    out = dict(calls)
    for name, kernel in BF16_KERNELS.items():
        out[name] = [c for c in calls[kernel] if c[0][0].dtype == BF16]
        out[kernel] = [c for c in calls[kernel] if c[0][0].dtype != BF16]
    return out


def bf16_ulp(x):
    """One bfloat16 ulp at |x|: 2^(e − 8) for |x| = m·2^e, m in [0.5, 1)."""
    _, e = torch.frexp(x.float().abs())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), (e - 8).clamp_min(-133))


def compare_bf16(name, got, ref, tol) -> float:
    """bfloat16 ``got`` within one bfloat16 ulp of ``ref`` plus ``tol`` of
    ref's scale (each side rounds its float32 value to bfloat16 once; the
    two float32 values differ by sum order, so they may round one ulp
    apart)."""
    d = (got.float() - ref.float()).abs()
    scale = float(ref.float().abs().max()) if ref.numel() else 0.0
    ok = bool((d <= bf16_ulp(ref) + tol * scale).all())
    require(ok, f"{name} {tuple(got.shape)}: max|d|={float(d.max()):.3g}, scale {scale:.3g}")
    return float(d.max()) if d.numel() else 0.0


def bits(t):
    """The bits of a float32 or bfloat16 tensor, on the CPU."""
    return t.detach().cpu().view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def require(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[phase] {name} ...", flush=True)
    yield
    print(f"[phase] {name} ok {time.perf_counter() - t0:.3f} s", flush=True)


@contextmanager
def cbl_route_env(route: str):
    """The environment that selects a CBL route: CBL_DENSE as CBL_ROUTES
    gives it, unset for None."""
    value = CBL_ROUTES[route][0]
    with mock.patch.dict(os.environ):
        if value is None:
            os.environ.pop("CBL_DENSE", None)
        else:
            os.environ["CBL_DENSE"] = value
        yield


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def frozen(x, device=None):
    """A copy of a call's tensor arguments (the attention layer passes views
    of weights that the optimizer then updates in place), on ``device``
    where given."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone() if device is None else x.detach().to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(frozen(v, device) for v in x)
    if isinstance(x, dict):
        return {k: frozen(v, device) for k, v in x.items()}
    return x


@contextmanager
def recording():
    """Record every call (arguments as they were and the kernel's outputs)
    of the kernel wrappers made through the ops modules while active."""
    calls = {name: [] for name in WRAPPERS}
    with ExitStack() as stack:
        for name, (mod, attr, _) in WRAPPERS.items():
            def rec(*args, _fn=getattr(mod, attr), _name=name, **kw):
                out = _fn(*args, **kw)
                calls[_name].append((frozen(args), kw, out))
                return out
            stack.enter_context(mock.patch.object(mod, attr, rec))
        yield calls


@contextmanager
def plain_kernels():
    """Swap every kernel for its plain PyTorch version."""
    with ExitStack() as stack:
        for mod, attr, plain in WRAPPERS.values():
            stack.enter_context(mock.patch.object(mod, attr, plain))
        yield


def reset_counts():
    wt.launches = tg.launches = tg.bwd_launches = 0
    for counts in (tg.dtype_launches, tg.bwd_dtype_launches, pa.fwd_dtype_launches,
                   pa.bwd_dtype_launches):
        counts.update(dict.fromkeys(counts, 0))
    cd.fwd_launches = cd.bwd_launches = 0
    pa.fwd_launches = pa.bwd_launches = 0
    c2.fwd_launches = c2.bwd_launches = c1.fwd_launches = c1.bwd_launches = 0
    gd.launches = fpk.launches = 0
    knn.wide_calls = 0


def read_counts() -> dict:
    return {"window_topk": wt.launches, "window_gather": tg.launches,
            "window_gather_bwd": tg.bwd_launches, "cbl_stats_fwd": cd.fwd_launches,
            "cbl_stats_bwd": cd.bwd_launches, "pt_attn_fwd": pa.fwd_launches,
            "pt_attn_bwd": pa.bwd_launches, "cbl_tile2_fwd": c2.fwd_launches,
            "cbl_tile2_bwd": c2.bwd_launches, "cbl_tile_fwd": c1.fwd_launches,
            "cbl_tile_bwd": c1.bwd_launches, "gather_rows": gd.launches, "fps": fpk.launches}


def read_dtype_counts() -> dict:
    """The gather and attention launches by the dtype of their operands."""
    return {"window_gather": dict(tg.dtype_launches),
            "window_gather_bwd": dict(tg.bwd_dtype_launches),
            "pt_attn_fwd": dict(pa.fwd_dtype_launches), "pt_attn_bwd": dict(pa.bwd_dtype_launches)}


def grid_cloud(rng, b, n, side=64):
    """Integer-grid cloud with duplicated rows: every distance is exact."""
    p = rng.integers(0, side, (b, n, 3)).astype(np.float32)
    for bb in range(b):
        p[bb, rng.integers(0, n, n // 8)] = p[bb, rng.integers(0, n, n // 8)]
    return p


def compare_topk(call, exact: bool) -> float:
    """Kernel output of a recorded call against the plain version."""
    (query, support, k), kw, (idx, val) = call
    p_idx, p_val = wt.window_topk_plain(query, support, k, **kw)
    err = float((val - p_val).abs().nan_to_num(0.0).max())
    same_inf = bool(torch.equal(torch.isinf(val), torch.isinf(p_val)))
    mismatch = float((idx != p_idx).float().mean())
    what = f"window_topk k={k} {kw}: max|dv|={err:.3g}, idx mismatch {mismatch:.3g}"
    if exact:
        require(torch.equal(idx, p_idx) and torch.equal(val, p_val), what)
    else:
        require(same_inf and err <= 1e-5 and mismatch <= 1e-4, what)
    return err


def compare_gather(call) -> float:
    """Bit for bit (float32 or bfloat16 rows)."""
    args, _, out = call
    ref = tg.window_gather_plain(*args)
    require(out.dtype == ref.dtype and torch.equal(bits(out), bits(ref)),
            f"window_gather {tuple(out.shape)} {out.dtype} differs")
    return 0.0


def compare_scaled(name, got, ref, tol) -> float:
    """max|got − ref| within ``tol`` of max|ref| (the output's scale)."""
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    require(err <= tol * scale, f"{name} {tuple(got.shape)}: max|d|={err:.3g}, scale {scale:.3g}")
    return err


def compare_gather_bwd(call) -> float:
    """Against the plain version on the card, whose index_add_ adds with
    atomics in no fixed order: 1e-5 of the output's scale, and exact on
    integer-valued cotangents at the same geometry (small integers sum
    exactly in any order). The kernel sums each row in slot order without
    atomics: the call run again gives the same bits, and so does the plain
    version on CPU copies (CPU index_add_ adds in index order)."""
    (g, li, starts, tile, width, ns), _, out = call
    what = f"window_gather_bwd {tuple(g.shape)} {g.dtype}"
    if g.dtype == BF16:  # one rounding of the plain version's float32 sum
        f32 = tg.window_gather_bwd_plain(g.float(), li, starts, tile, width, ns)
        err = compare_bf16("window_gather_bwd", out, f32, 0.0)
    else:
        err = compare_scaled("window_gather_bwd", out, tg.window_gather_bwd_plain(*call[0]), 1e-5)
    g_int = torch.randint_like(g, -3, 4)
    require(torch.equal(tg.window_gather_bwd(g_int, li, starts, tile, width, ns),
                        tg.window_gather_bwd_plain(g_int, li, starts, tile, width, ns)),
            f"{what} not exact on integer cotangents")
    require(torch.equal(bits(tg.window_gather_bwd(*call[0])), bits(out)),
            f"{what} differs between runs")
    cpu = tg.window_gather_bwd_plain(g.cpu(), li.cpu(), starts.cpu(), tile, width, ns)
    require(torch.equal(bits(cpu), bits(out)), f"{what} is not the plain version's CPU sum bit for bit")
    return err


def compare_stats_fwd(call) -> float:
    """Counts exact, the rest rel 1e-5 (the same arithmetic; exp and the
    sums over slots may round differently); the call run again gives the
    same bits on every lane (lane 0, m̂, is what the backward reads)."""
    args, _, out = call
    out = out.detach()
    ref = cd.cbl_stats_fwd_plain(*args)
    require(torch.equal(out[..., 3:], ref[..., 3:]), f"cbl_stats_fwd {tuple(out.shape)}: counts differ")
    err = float((out[..., :3] - ref[..., :3]).abs().max())
    require(bool(torch.allclose(out[..., :3], ref[..., :3], rtol=1e-5, atol=1e-7)),
            f"cbl_stats_fwd {tuple(out.shape)}: max|d|={err:.3g}")
    again = cd.cbl_stats_fwd(*args)
    require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
            f"cbl_stats_fwd {tuple(out.shape)}: differs between runs")
    return err


def compare_stats_bwd(call) -> float:
    """Against the plain version (1e-4 of the output's scale: the sums
    over a row's slots meet in another order, and the plain version's
    index_add_ adds with atomics on the card); the call run again gives the
    same bits (no atomics); the first pass's slot coefficients cd within
    1e-5 of their scale of the plain version's (the same roundings; exp may
    round otherwise)."""
    args, _, out = call
    what = f"cbl_stats_bwd {tuple(out.shape)}"
    err = compare_scaled(what, out, cd.cbl_stats_bwd_plain(*args), 1e-4)
    again, coef = cd.cbl_stats_bwd_passes(*args)
    bits = lambda t: t.cpu().view(torch.int32)
    require(torch.equal(bits(again), bits(out)), f"{what} differs between runs")
    compare_scaled(f"{what} pass-1 cd", coef, cd.cbl_bwd_cd_plain(*args)[0], 1e-5)
    return err


def compare_pt_attn_fwd(call) -> float:
    """out and both statistic pairs within 1e-4 of their scale (the kernel
    sums over slots and blocks in another order, and rounds exp otherwise);
    the call run again gives the same bits of all three (no atomics, the
    blocks' partial rows summed in order)."""
    args, _, got = call
    got = [t.detach() for t in got]
    ref = pa.pt_attn_plain(*args)
    again = pa.pt_attn_fwd(*args)
    err = 0.0
    for what, a, r, a2 in zip(("out", "s1", "s2"), got, ref, again):
        name = f"pt_attn_fwd {what} {tuple(a.shape)}"
        if a.dtype == BF16:  # a bfloat16 out: one rounding of each side's float32 out
            err = max(err, compare_bf16(name, a, r, 1e-4))
        else:
            err = max(err, compare_scaled(name, a, r, 1e-4))
        require(torch.equal(bits(a), bits(a2)), f"{name} differs between runs")
    return err


PT_GRADS = ("dq", "dkv", "dA1", "dc1", "dW2", "db2", "dg1", "dh1", "dW3", "db3", "dg2", "dh2",
            "dW4", "db4")


def compare_pt_attn_bwd(call) -> float:
    """dq, dkv and the 12 parameter gradients within 1e-4 of their scale.
    db4 is zero in exact arithmetic (b4 shifts every slot's score alike,
    which a softmax ignores), so both values are rounding noise: it is held
    to 1e-4 of dW4's scale."""
    args, _, (dq, dkv, grads) = call
    r_dq, r_dkv, r_grads = pa.pt_attn_bwd_plain(*args)
    got, ref = (dq, dkv, *grads), (r_dq, r_dkv, *r_grads)
    err = 0.0
    for name, a, b in zip(PT_GRADS, got, ref):
        if a.dtype == BF16:  # dq and dkv of bfloat16 q and kv
            err = max(err, compare_bf16(f"pt_attn_bwd {name}", a, b, 1e-4))
            continue
        scale_of = ref[PT_GRADS.index("dW4")] if name == "db4" else b
        e = float((a - b).abs().max())
        require(e <= 1e-4 * float(scale_of.abs().max()),
                f"pt_attn_bwd {name} {tuple(a.shape)}: max|d|={e:.3g}, scale {float(scale_of.abs().max()):.3g}")
        err = max(err, e)
    return err


def check_pt_attn_bwd_exact(call):
    """dkv exact on integer-valued cotangents: with W4 = 0 every score is
    b4, so att = 1/K and d(v + pe) = g/K are exact dyadic numbers, and the
    atomics' sums of them are exact in any order (dk is then exactly 0)."""
    (q, kv, rel, li, starts, tile, width, params, g), _, _ = call
    ps = list(params)
    ps[10] = torch.zeros_like(ps[10])
    g_int = torch.randint_like(g, -3, 4)
    dkv = pa.pt_attn_bwd(q, kv, rel, li, starts, tile, width, ps, g_int)[1]
    ref = pa.pt_attn_bwd_plain(q, kv, rel, li, starts, tile, width, ps, g_int)[1]
    require(torch.equal(dkv, ref), f"pt_attn_bwd dkv {tuple(dkv.shape)} not exact on integer cotangents")


def compare_tile_stats(name, call) -> float:
    """Per-row statistics of a CBL tile kernel call (v2 or v1) against its
    plain version: the counts and the mask exact on every row, the max, the
    sums and loss·mask within 1e-4 of each lane's scale (the distances are
    rounded in one order on both sides; exp and log may round otherwise on
    the card). The kernels compute the max and the sums (lanes 0-2) only on
    the rows of the mask: there they are held so, elsewhere they must be the
    fill (0, 0, 0) with lane 5 zero (no output reads them there); lane 7 is
    0; the call run again gives the same bits on every lane."""
    args, kw, out = call
    mod, attr, plain = WRAPPERS[name]
    ref = plain(*args, **kw)
    exact = [3, 4, 6]
    require(torch.equal(out[..., exact], ref[..., exact]),
            f"{name} {tuple(out.shape)}: counts or mask differ")
    mask = out[..., 6] > 0
    require(not out[~mask][:, [0, 1, 2, 5]].any() and not out[..., 7].any(),
            f"{name} {tuple(out.shape)}: not the fill outside the mask")
    again = getattr(mod, attr)(*args, **kw)
    require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
            f"{name} {tuple(out.shape)}: differs between runs")
    return max(compare_scaled(f"{name} lane {i} (masked rows)", out[mask][:, i], ref[mask][:, i],
                              1e-4) for i in (0, 1, 2, 5))


def compare_tile_grad(name, call) -> float:
    """A CBL tile backward call against its plain version: 1e-4 of the
    output's scale (the sums meet in another order, and the plain version's
    index_add_ adds with atomics on the card). Neither form has atomics: the
    call run again gives the same bits. v2's first pass's slot
    coefficients, on the rows it serves, are within 1e-5 of their scale of
    the plain version's (the same roundings; exp may round otherwise). v1
    runs v2's kernels on its split of the fused rows: its label columns are
    zero and its feature columns are v2's backward bit for bit on the
    split's features and meta (``cbl_tile.split_plain``) with the same
    statistics."""
    args, kw, out = call
    if name == "cbl_tile_bwd":
        fused, li, stats, g, ncls = args[:5]
        what = f"{name} {tuple(out.shape)}"
        require(not out[..., :ncls].any(), f"{what}: a label column has a gradient")
        again = c1.cbl_tile_bwd(*args, **kw)
        require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
                f"{what} differs between runs")
        meta = c1.split_plain(fused, ncls)[1]
        v2 = c2.cbl_tile2_bwd(fused[..., ncls:], meta, li, stats, g, *args[5:])
        require(torch.equal(out[..., ncls:].contiguous().view(torch.int32), v2.view(torch.int32)),
                f"{what}: the feature columns are not v2's backward bit for bit")
    else:
        again, coef = c2.cbl_tile2_bwd_passes(*args, **kw)
        require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
                f"{name} {tuple(out.shape)}: differs between runs")
        features, meta, li, stats, g = args[:5]
        served = (stats[..., 6] != 0) & (g[:, None] != 0)  # pass 1 writes their slots
        ref = c2.grad_coefs_plain(features, meta[..., 0], meta[..., 1], li, stats, g,
                                  *args[5:])[0]
        compare_scaled(f"{name} {tuple(out.shape)} pass-1 coef", coef[served], ref[served], 1e-5)
    return compare_scaled(name, out, WRAPPERS[name][2](*args, **kw), 1e-4)


def compare_call(name, call, exact_topk=False) -> float:
    name = base(name)
    if name in ("cbl_tile2_fwd", "cbl_tile_fwd"):
        return compare_tile_stats(name, call)
    if name in ("cbl_tile2_bwd", "cbl_tile_bwd"):
        return compare_tile_grad(name, call)
    if name == "gather_rows":
        args, _, out = call
        require(torch.equal(out, gd.gather_rows_plain(*args)), "gather_rows differs")
        return 0.0
    if name == "fps":
        args, _, out = call
        plain = fpk.fps_chains_plain(*args)
        require(torch.equal(out, plain), f"fps picks differ at {tuple(args[0].shape)}, "
                f"{args[1]} picks: {int((out != plain).sum())} of {out.numel()}")
        return float((out - plain).abs().max()) if out.numel() else 0.0
    if name == "pt_attn_fwd":
        return compare_pt_attn_fwd(call)
    if name == "pt_attn_bwd":
        return compare_pt_attn_bwd(call)
    if name == "window_topk":
        return compare_topk(call, exact_topk)
    if name == "window_gather":
        return compare_gather(call)
    if name == "window_gather_bwd":
        return compare_gather_bwd(call)
    if name == "cbl_stats_fwd":
        return compare_stats_fwd(call)
    return compare_stats_bwd(call)


def check_kernels(dev, points_sets) -> float:
    """Phase 2: every kernel call of the eval pyramid of each cloud."""
    err = 0.0
    spec = PyramidSpec()
    for name, pts, exact in points_sets:
        with recording() as calls:
            build_pyramid(torch.as_tensor(pts, device=dev), spec)
        for c in calls["window_topk"]:
            err = max(err, compare_topk(c, exact))
        for c in calls["window_gather"]:
            err = max(err, compare_gather(c))
        print(f"  {name}: {len(calls['window_topk'])} window_topk and "
              f"{len(calls['window_gather'])} window_gather calls agree "
              f"({'exact' if exact else 'tolerance'})", flush=True)
    return err


def check_topk_modes(dev, pts) -> float:
    """window_topk where no eval or train geometry of the sorted layout
    takes it (its train and serve paths use the plain and ensure_self modes
    with k <= W): k > W in the self and cross geometries, and exclude_self
    with k <= W and k > W; and the top-1 tie bit of the natural layout's
    windowed searches (last_ties, k = 1) in each mode at each window size
    class of the kernel (32 · 8, 16, 24, 32, 48, 64 rows a lane), with
    exclude_self where the excluded self is the last of the tied rows; on
    an integer-grid cloud with duplicated rows, held to exact equality."""
    p = torch.as_tensor(pts, device=dev)
    small = p[:, :2048].contiguous()
    cross = p[:, ::4].contiguous()
    cases = (
        ("exclude_self", p, p, 16, dict(tile=256, width=3, window=1)),
        ("plain", small, small, 12, dict(tile=8, width=1, window=0)),
        ("exclude_self", small, small, 12, dict(tile=8, width=1, window=0)),
        ("plain", cross, p, 300, dict(tile=256, width=1, window=0)),
        ("plain", cross, p, 1, dict(tile=256, width=1, window=0, last_ties=True)),
        ("exclude_self", p, p, 1, dict(tile=256, width=2, window=1, last_ties=True)),
        ("ensure_self", p, p, 1, dict(tile=256, width=3, window=1, last_ties=True)),
        ("plain", cross, p, 1, dict(tile=256, width=4, window=1, last_ties=True)),
        ("exclude_self", p, p, 1, dict(tile=256, width=6, window=3, last_ties=True)),
        ("plain", p, cross, 1, dict(tile=256, width=8, window=3, last_ties=True)),
        ("exclude_self", small, small, 1, dict(tile=8, width=1, window=0, last_ties=True)),
    )
    for mode, query, support, k, geo in cases:
        kw = dict(geo, mode=mode)
        out = wt.window_topk(query, support, k, **kw)
        compare_topk(((query, support, k), kw, out), exact=True)
        print(f"  window_topk mode={mode} k={k} W={geo['tile'] * geo['width']} "
              f"M={query.shape[1]} Ns={support.shape[1]} ties "
              f"{'last' if geo.get('last_ties') else 'first'}: equal to the plain version",
              flush=True)
    return 0.0


GATHER_WIDTHS = (1, 2, 3, 5, 35, 67, 131, 259, 1024)


def check_gather_widths(dev) -> float:
    """window_gather at the widths of GATHER_WIDTHS, in the self geometry
    (tile 256, width 3, K 16) and the cross one (16384 queries on 65536
    support rows, width 6, K 3), with repeated and shadow slots, and at C =
    1024 from an x that is not 16-byte aligned (the scalar-read path at C %
    4 == 0): each equal to the plain version."""
    rng = np.random.default_rng(6)
    tile = 256
    cases = []
    for c in GATHER_WIDTHS:
        for m, ns, k, width, window in ((4096, 4096, 16, 3, 1), (16384, 65536, 3, 6, 1)):
            if c == 1024 and ns == 65536:
                continue  # 2 GB of output; the self case covers the width
            cases.append((c, m, ns, k, width, window, 0))
    cases.append((1024, 4096, 4096, 16, 3, 1, 1))
    for c, m, ns, k, width, window, shift in cases:
        buf = torch.as_tensor(rng.standard_normal(B * ns * c + shift, dtype=np.float32), device=dev)
        x = buf[shift:].view(B, ns, c)
        w_sz = width * tile
        li = rng.integers(0, w_sz + 1, (B, m, k)).astype(np.int32)
        li[:, ::7, -1] = w_sz  # shadow slots
        starts = wt.window_start_tiles(m // tile, ns // tile, width, window)
        li_t = torch.as_tensor(li, device=dev)
        st = torch.as_tensor(starts, dtype=torch.int32, device=dev)
        out = tg.window_gather(x, li_t, st, tile, width)
        compare_gather(((x, li_t, st, tile, width), {}, out))
        plan = tg.gather_plan(B * m * k, c, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        print(f"  window_gather C={c} x {tuple(x.shape)}{' misaligned' if shift else ''} idx "
              f"{tuple(li.shape)} W={w_sz} {plan}: equal to the plain version", flush=True)
    return 0.0


def random_flax_tree(model, seed: int) -> dict:
    """Seeded random weights as a flax tree for the converter (used only when
    the checkpoint file is absent)."""
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "batch_stats": {}}
    for key, v in model.state_dict().items():
        *path, leaf = key.split(".")
        mod = model.get_submodule(".".join(path))
        shape = tuple(v.shape)
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", "mean" if leaf == "running_mean" else "var"
            a = rng.random(shape) + 0.5 if name == "var" else 0.1 * rng.standard_normal(shape)
        elif leaf == "weight" and isinstance(mod, torch.nn.Linear):
            coll, name = "params", "kernel"
            a = rng.standard_normal(shape[::-1]) / np.sqrt(shape[1])
        else:
            coll, name = "params", "scale" if leaf == "weight" else "bias"
            a = 1.0 + 0.1 * rng.standard_normal(shape) if name == "scale" else 0.1 * rng.standard_normal(shape)
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = a.astype(np.float32)
    return tree


def load_model(bn_mode="batch", dtype=torch.float32, **head_kw):
    """The flagship checkpoint (seeded random weights where it is absent)
    in a PointTransformerSeg; ``head_kw`` are MultiHead options that add no
    weights (contrast_ftype='f_out')."""
    model = PointTransformerSeg(num_classes=NUM_CLASSES, bn_mode=bn_mode, dtype=dtype, **head_kw)
    if CKPT.exists():
        return load_jax_variables(model, load_checkpoint(str(CKPT))), True
    print(f"checkpoint {CKPT} is absent: seeded random weights, no accuracy floor",
          flush=True)
    return load_jax_variables(model, random_flax_tree(model, 0)), False


def room0(seed=0):
    return SyntheticSceneDataset(num_rooms=1, points_per_room=120_000, seed=seed, split="val")


def time_ms(fn, flush_buf=None, reps=10) -> float:
    """Mean device time of fn over reps runs (CUDA events), each after an L2
    flush when flush_buf is given."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush_buf is not None:
            flush_buf.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def topk_library_call(query, support, k, *, tile, width, window, mode="plain",
                      last_ties=False):
    """torch.topk over the window distance tensor (built outside the timed
    call): the library yardstick, which leaves out the distances."""
    b, m, _ = query.shape
    gq, gs = m // tile, support.shape[1] // tile
    starts = torch.as_tensor(wt.window_start_tiles(gq, gs, width, window), device=query.device)
    cols = starts[:, None] + torch.arange(width, device=query.device)[None, :]
    win = support.reshape(b, gs, tile, 3)[:, cols].reshape(b, gq, width * tile, 3)
    neg = -torch.cdist(query.reshape(b, gq, tile, 3), win).square()
    kk = min(k, width * tile)
    return lambda: torch.topk(neg, kk, dim=-1)


def gather_library_call(x, local_idx, starts, tile, width):
    """x[b, rows] advanced indexing with the global rows built outside the
    timed call (shadow rows read row 0 instead of zeros)."""
    row0 = torch.repeat_interleave(starts.long() * tile, tile)
    rows = (row0[None, :, None] + local_idx.long()).clamp_max(x.shape[1] - 1)
    bidx = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return lambda: x[bidx, rows]


def gather_bwd_library_call(g, local_idx, starts, tile, width, n_support):
    """index_add_ of g's rows onto zeros with the global rows built outside
    the timed call (shadow slots add onto row 0 instead of nothing); for a
    bfloat16 g, the float32 index_add_ of g.float(), then .to(bfloat16)."""
    b, m, k, c = g.shape
    row0 = torch.repeat_interleave(starts.long() * tile, tile)
    rows = (row0[None, :, None] + local_idx.long()).clamp_max(n_support - 1)
    rows = (rows + torch.arange(b, device=g.device)[:, None, None] * n_support).reshape(-1)
    src = g.reshape(-1, c)
    if g.dtype == BF16:
        return lambda: torch.zeros(b * n_support, c, device=g.device).index_add_(
            0, rows, src.float()).to(BF16)
    return lambda: torch.zeros(b * n_support, c, device=g.device).index_add_(0, rows, src)


def tile_costs(name, args, out):
    """(bytes, FP32 operations, shape) that a CBL tile kernel call's function
    needs on this call's data. Every row's li and label (v2: meta lanes 0
    and 1; v1: its ncls label columns) decide the slot counts and so the
    loss mask. Only the rows of the mask (in the backward: with a cotangent
    != 0) need their features, the labels and features of the rows their
    slots name (features of the valid ones), the distances and the sums.
    The forward's outputs are the two [B] sums (not the statistics it keeps
    for the backward); the backward reads every row's statistics and writes
    its whole gradient. Operations: a label's argmax and sum 2·ncls a row
    (v1), 4 a valid slot for the counts; per valid slot of a masked row the
    distance 3C + 2 and the max, exp and sums ~26 forward, ~6C + 70
    backward."""
    v1, fwd = name.startswith("cbl_tile_"), name.endswith("fwd")
    x, li = (args[0], args[1]) if v1 else (args[0], args[2])
    ncls = (args[2] if fwd else args[4]) if v1 else 0
    tile, width, window = args[-3:]
    b, m, k = li.shape
    c = x.shape[-1] - ncls
    valid = x[..., :ncls].sum(-1) > 0 if v1 else args[1][..., 1] > 0
    stats = out if fwd else args[2] if v1 else args[3]
    mask = stats[..., 6] > 0
    if not fwd:
        mask &= (args[3] if v1 else args[4])[:, None] != 0
    starts = torch.as_tensor(cd.self_window_starts(m, tile, width, window), device=x.device)
    rows, member = tg._rows(li, starts, tile, width, m)
    slot_ok = member & valid.reshape(-1)[rows]
    m_rows, m_member, m_ok = rows[mask], member[mask], slot_ok[mask]
    q_rows = torch.nonzero(mask.reshape(-1)).squeeze(1)
    named = int(torch.unique(torch.cat([q_rows, m_rows[m_member]])).numel())
    need = int(torch.unique(torch.cat([q_rows, m_rows[m_ok]])).numel())
    n_mask, n_masked_slots = int(mask.sum()), float(m_ok.sum())
    label_bytes = 4 * ncls if v1 else 8
    if fwd:
        n_bytes = b * m * (4 * k + label_bytes) + 4 * c * need + 8 * b
        n_ops = b * m * 2 * ncls + 4 * float(slot_ok.sum()) + n_masked_slots * (3 * c + 28)
    else:
        n_bytes = (b * m * (32 + 4 * x.shape[-1]) + 4 * b + 4 * k * n_mask
                   + label_bytes * named + 4 * c * need)
        n_ops = named * 2 * ncls + n_masked_slots * (6 * c + 70)
    shape = dict(rows=list(x.shape), K=k, ncls=ncls, masked_rows=n_mask,
                 masked_valid_slots=int(n_masked_slots), rows_read=need)
    return float(n_bytes), float(n_ops), shape


def attn_slot_ops(c: int, cs: int) -> tuple:
    """FP32 operations a slot-row of the fused attention needs, (forward,
    backward), counted from the plain versions: a product over n inputs is
    2n with its bias add, a ReLU or mask 1 an element.
    Forward: the PE tower 21 + 6C; w_pre and the bn1 affine 4C, ReLU C; fc1
    2C·Cs; the bn2 affine and ReLU 3Cs; fc2 2Cs²; the softmax over the
    slots 5Cs (max, subtract, exp, sum, divide) on the Cs weight channels;
    Σ att·(v + pe) 3C; the statistics 3C + 3Cs.
    Backward: the forward up to the softmax again; g·(v + pe) and dalpha
    3C, S and dw4 4Cs, dvpe C; dW4 and dc_ 4Cs² + Cs, db4 Cs; dg2, dh2 and
    dbv 4Cs; dW3 and db3 2C·Cs + Cs; da 2C·Cs + C; dg1, dh1 and dw_pre 4C;
    dq C; dk|dv 2C; dpe C; dW2 and db2 7C; dr_pe 6C + 3; dA1 and dc1 21."""
    fwd = 21 + 17 * c + 2 * c * cs + 2 * cs * cs + 11 * cs
    bwd = 45 + 37 * c + 6 * c * cs + 6 * cs * cs + 19 * cs
    return fwd, bwd


def call_costs(name, call):
    """(kernel fn, plain fn, library fn or None, bytes, operations, shape)
    of one recorded call."""
    args, kw, out = call
    name = base(name)
    mod, attr, plain_fn = WRAPPERS[name]
    kern = lambda: getattr(mod, attr)(*args, **kw)
    plain = lambda: plain_fn(*args, **kw)
    if name == "window_topk":
        query, support, k = args
        b, m, _ = query.shape
        w_sz = kw["width"] * kw["tile"]
        n_bytes = 4 * (query.numel() + support.numel()) + 8 * b * m * k
        n_ops = 10.0 * b * m * w_sz  # 9 FLOPs of distance + 1 compare a pair
        shape = dict(k=k, B=b, M=m, Ns=support.shape[1], W=w_sz, mode=kw.get("mode", "plain"),
                     ties="last" if kw.get("last_ties") else "first")
        return kern, plain, topk_library_call(query, support, k, **kw), n_bytes, n_ops, shape
    size = lambda t: t.element_size() * t.numel()  # bytes, at the tensor's dtype
    if name == "window_gather":
        x, li, starts, tile, width = args
        n_bytes = size(x) + size(li) + size(starts) + size(out)
        shape = dict(x=list(x.shape), idx=list(li.shape), W=tile * width, dtype=str(x.dtype))
        return kern, plain, gather_library_call(*args), n_bytes, 0.0, shape
    if name == "window_gather_bwd":
        g, li, starts, tile, width, ns = args
        n_bytes = size(g) + size(li) + size(starts) + size(out)
        shape = dict(g=list(g.shape), Ns=ns, W=tile * width, dtype=str(g.dtype))
        return kern, plain, gather_bwd_library_call(*args), n_bytes, float(g.numel()), shape
    if name in ("cbl_tile2_fwd", "cbl_tile2_bwd", "cbl_tile_fwd", "cbl_tile_bwd"):
        n_bytes, n_ops, shape = tile_costs(name, args, out)
        return kern, plain, None, n_bytes, n_ops, shape
    if name == "gather_rows":
        # idx read once, the distinct rows it names read once, out written once
        x, idx = args[:2]
        rows = int(torch.unique(idx).numel())
        n_bytes = 4 * idx.numel() + x.element_size() * x.shape[1] * (rows + idx.numel())
        idx_long = idx.long()
        shape = dict(x=list(x.shape), M=idx.numel(), distinct_rows=rows)
        return (kern, plain, lambda: torch.index_select(x, 0, idx_long), n_bytes, 0.0,
                shape)
    if name == "fps":
        # points read once, picks written once; 9 FP32 operations and one
        # compare a row a step, m_per - 1 steps one after another
        grouped, m_per = args
        p, per, _ = grouped.shape
        steps = max(m_per - 1, 0)
        shape = dict(buckets=p, rows=per, picks=m_per, chain_steps=steps)
        return kern, plain, None, size(grouped) + size(out), 10.0 * p * per * steps, shape
    if name in ("pt_attn_fwd", "pt_attn_bwd"):
        # inputs read once, outputs written once, each at its dtype (q, kv,
        # out, g_out, dq and dkv bfloat16 in a bf16 call); FP32 operations of
        # the plain versions' slot-rows (attn_slot_ops)
        q, kv, rel, li, starts, tile, width, params = args[:8]
        b, m, c = q.shape
        k, cs = li.shape[-1], params[6].shape[-1]
        fwd_ops, bwd_ops = attn_slot_ops(c, cs)
        nbytes = lambda ts: sum(size(t) for t in ts)
        n_bytes = nbytes((q, kv, rel, li, starts)) + nbytes(params)
        if name == "pt_attn_fwd":
            n_bytes += nbytes(out)
            n_ops = b * m * k * fwd_ops
        else:
            dq, dkv, grads = out
            n_bytes += nbytes((args[8], dq, dkv)) + nbytes(grads)
            n_ops = b * m * k * bwd_ops
        shape = dict(B=b, M=m, C=c, K=k, W=tile * width, dtype=str(q.dtype))
        return kern, plain, None, n_bytes, float(n_ops), shape
    # stats: inputs read once, outputs written once; per valid listed slot
    # about 4C + 12 FP32 operations forward and 8C + 16 backward
    features, meta, li = args[:3]
    temperature, tile, width, window = args[-4:]
    valid = float(cd.cbl_stats_fwd_plain(features, meta, li, temperature, tile, width, window)[..., 4].sum())
    c = features.shape[-1]
    n_bytes = 4 * (features.numel() + meta.numel() + li.numel())
    if name == "cbl_stats_fwd":
        n_bytes += 4 * out.numel()
        n_ops = valid * (4 * c + 12)
    else:
        # the forward's m̂ (one lane of its stats), the cotangent, dx
        n_bytes += 4 * (features.shape[0] * features.shape[1] + args[4].numel() + out.numel())
        n_ops = valid * (8 * c + 16)
    shape = dict(features=list(features.shape), K=li.shape[-1], tile=tile, width=width,
                 valid_slots=int(valid))
    return kern, plain, None, n_bytes, n_ops, shape


@torch.no_grad()
def time_calls(calls, dev, launches, max_err, names, reps=10, records=None) -> list:
    """Hold each recorded launch against the plain version, then time it;
    per-kernel sums over the recorded run (and, into ``records`` where
    given, (name, shape, kernel ms, bound ms) of each launch)."""
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    summary = []
    for name in names:
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0)
        has_lib = True
        for call in calls[name]:
            max_err[name] = max(max_err[name], compare_call(name, call))
            kern, plain, lib, n_bytes, n_ops, shape = call_costs(name, call)
            t_k, t_p = (time_ms(f, flush_buf, reps) for f in (kern, plain))
            t_l = None if lib is None else time_ms(lib, flush_buf, reps)
            has_lib = has_lib and t_l is not None
            bnd, t_b, t_o = bound_ms(n_bytes, n_ops)
            lib_txt = "n/a" if t_l is None else f"{t_l:.4f} ms"
            print(f"  {name} {shape}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                  f"library {lib_txt}, bound {bnd:.5f} ms", flush=True)
            if records is not None:
                records.append((base(name), shape, t_k, bnd))
            for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l or 0.0),
                           ("bound_ms", bnd), ("t_bytes", t_b), ("t_ops", t_o)):
                tot[key] += v
        summary.append(dict(
            name=name, route="cuda", **KERNELS[name], launches=launches[name],
            max_abs_err=max_err[name], ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by="operations" if tot["t_ops"] > tot["t_bytes"] else "bytes",
            library_ms=tot["library_ms"] if has_lib else None,
        ))
    return summary


def profile_request(step, batch, top=12, what="request"):
    """One request (or train step) under torch.profiler: device time by
    kernel name and the device's busy share of its wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device events only; "Optimizer.step#SGD.step"-style names are the
    # profiler's own annotations spanning kernels, not device work (kernel
    # names hold spaces or parentheses)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not re.fullmatch(r"[\w.]+#[\w.]+", e.key)]
    events = sorted(kernels, key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    n_dev = sum(e.count for e in events)
    print(f"profiled {what}: {n_dev} device events, wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f})", flush=True)
    for e in events[:top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}", flush=True)
    return busy_ms


def snapshot(model, opt):
    return copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())


def restore(model, opt, snap):
    model.load_state_dict(snap[0])
    opt.load_state_dict(copy.deepcopy(snap[1]))  # the optimizer keeps what it is given


def grad_norm(model) -> float:
    return float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                for p in model.parameters() if p.grad is not None)))


def buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_buffers()}


def run_train(dev, bn_mode="batch", route="dense", dtype=torch.float32,
              spec=TRAIN_SPEC, contrast=ContrastConfig(), head_kw=None) -> dict:
    """Phases 8, 10, 12, 13, 17, 18, 44 and 46: the flagship train step at B
    x N from the checkpoint, with flax batch BN or stale BN, on one of the
    CBL routes (the caller selects it with cbl_route_env), float32 or
    bfloat16, on the flagship's pyramid or ``spec``, with the flagship's
    CBL or ``contrast`` (its impl the route's) and the MultiHead options
    ``head_kw`` that add no weights. The
    kernel-vs-plain step tolerances of a bfloat16 step (loss 1e-3, gradient
    norm and running statistics 1e-2) allow for the values that the
    kernels' and the plain versions' float32 sums, in their different
    orders, leave at a bfloat16 rounding boundary: those round one ulp
    (2^-8) apart and move the step further than float32 order does."""
    _, impl, cbl_kernels = CBL_ROUTES[route]
    require(cbl_losses.dense_route() == (route == "dense"), f"CBL_DENSE does not select {route}")
    kernels = PATH_KERNELS + cbl_kernels
    if bn_mode == "stale":
        kernels += ("pt_attn_fwd", "pt_attn_bwd")
    bf16 = dtype == BF16
    what = f"{bn_mode} BN" + ("" if route == "dense" else f", CBL route {route}") + (
        ", bfloat16" if bf16 else "")
    model, trained = load_model(bn_mode, dtype, **(head_kw or {}))
    opt = make_optimizer(model.parameters(), TRAIN_LR)
    cfg = TrainStepConfig(num_classes=NUM_CLASSES, spec=spec,
                          contrast=dataclasses.replace(contrast, impl=impl))
    step = make_train_step(model, cfg, opt, device=dev)
    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    batch = train_batch(rooms, B, N, np.random.default_rng(0))
    snap0 = snapshot(model, opt)
    step(batch)  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    restore(model, opt, snap0)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        print("  step: " + ", ".join(f"{k} {float(v):.6f}" for k, v in m.items()
                                      if k != "confusion"), flush=True)
    med = statistics.median(secs[2:])
    peak = torch.cuda.max_memory_allocated()
    print(f"train step ({what}) median of 3 warm steps {med * 1e3:.3f} ms over "
          f"{[round(x * 1e3, 3) for x in secs]}, {B * N / med:.1f} points/s, "
          f"max_memory_allocated {peak} B", flush=True)
    require(all(np.isfinite(losses)), f"losses {losses}")
    require(losses[-1] < losses[0], f"5 steps on one batch did not lower the loss: {losses}")
    busy_ms = profile_request(step, batch, what="train step")
    print(f"device busy {busy_ms:.3f} ms of the unprofiled median step "
          f"{med * 1e3:.3f} ms: busy share {busy_ms / (med * 1e3):.3f}", flush=True)
    if route == "dense":  # the pyramid is the same on every route
        pts_dev = torch.as_tensor(batch["points"], device=dev)
        pyr_ms = time_ms(lambda: build_pyramid(pts_dev, spec), reps=3)
        print(f"device time of the training pyramid alone {pyr_ms:.3f} ms", flush=True)

    restore(model, opt, snap0)
    torch.cuda.synchronize()
    reset_counts()
    wide_args, wide_fn = [], knn.window_topk_wide
    stage_inputs, v2_fn = [], cbl_losses.cbl_tile_softnn2

    def rec_wide(*args, **kw):
        wide_args.append((args, kw))
        return wide_fn(*args, **kw)

    def rec_v2(*args, **kw):
        stage_inputs.append(frozen(args))
        return v2_fn(*args, **kw)

    with recording() as calls, mock.patch.object(knn, "window_topk_wide", rec_wide), \
            mock.patch.object(cbl_losses, "cbl_tile_softnn2", rec_v2):
        m = step(batch)
        torch.cuda.synchronize()
    counts, wide, by_dtype = read_counts(), knn.wide_calls, read_dtype_counts()
    launches = {k: counts[k] for k in kernels}
    print(f"launches in one train step ({what}): {launches}; wide-window searches "
          f"(plain PyTorch): {wide}; by dtype {by_dtype}", flush=True)
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    require(all(launches[k] == STAGES for k in cbl_kernels),
            f"not one launch of each CBL kernel a stage: {launches}")
    others = {k: counts[k] for k in CBL_KERNELS if k not in cbl_kernels}
    require(not any(others.values()), f"another route's CBL kernel was launched: {others}")
    no_path = {k: counts[k] for k in NO_PATH_KERNELS}
    require(not any(no_path.values()), f"a kernel of no path was launched: {no_path}")
    metrics = {k: float(v) for k, v in m.items() if k != "confusion"}
    for args, kw in wide_args if route == "dense" else ():
        t = time_ms(lambda: wide_fn(*args, **kw), reps=3)
        print(f"  wide-window search k={args[2]} M={args[0].shape[1]} "
              f"W={kw['width'] * kw['tile']}: {t:.4f} ms", flush=True)
    loss_k, gn_k = step_against_plain(model, opt, step, batch, snap0, m, bf16)
    return dict(calls=calls, launches=launches, model=model, step=step, peak=peak, med=med,
                metrics=metrics, stage_inputs=stage_inputs, no_path=no_path, loss=loss_k,
                grad_norm=gn_k, busy_ms=busy_ms, by_dtype=by_dtype, opt=opt, snap0=snap0,
                batch=batch, cfg=cfg)


def step_against_plain(model, opt, step, batch, snap0, m, bf16=False) -> tuple:
    """The kernel step whose metrics are ``m``, just taken from ``snap0``,
    against the plain versions' step from the same weights and batch:
    loss rel <= 1e-4, global gradient norm rel <= 1e-3, running statistics
    rel <= 1e-4 (bfloat16: 1e-3, 1e-2, 1e-2). → the kernel step's (loss,
    gradient norm)."""
    loss_k, gn_k, stats_k = float(m["loss"]), grad_norm(model), buffers(model)
    require(np.isfinite(loss_k) and np.isfinite(gn_k), f"loss {loss_k}, grad norm {gn_k}")
    restore(model, opt, snap0)
    step.count -= 1  # the same update count: the same dropout and rand<k> keys
    with plain_kernels():
        m = step(batch)
    loss_p, gn_p, stats_p = float(m["loss"]), grad_norm(model), buffers(model)
    stats_rel = max(float((stats_k[n] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                    for n, v in stats_p.items())
    print(f"kernels vs plain, same weights and batch: loss {loss_k:.7f} vs {loss_p:.7f} "
          f"(rel {abs(loss_k - loss_p) / abs(loss_p):.3g}), gradient norm {gn_k:.7f} vs "
          f"{gn_p:.7f} (rel {abs(gn_k - gn_p) / gn_p:.3g}), running statistics rel "
          f"{stats_rel:.3g}", flush=True)
    tol_loss, tol_gn, tol_stats = (1e-3, 1e-2, 1e-2) if bf16 else (1e-4, 1e-3, 1e-4)
    require(abs(loss_k - loss_p) <= tol_loss * abs(loss_p), "train losses disagree")
    require(abs(gn_k - gn_p) <= tol_gn * gn_p, "gradient norms disagree")
    require(stats_rel <= tol_stats, "running statistics disagree")
    return loss_k, gn_k


def check_train_kernels(dev, train) -> list:
    """Phase 9: every kernel call of one train step on integer-grid clouds
    (exact top-k) against the plain versions; then every call of the
    recorded step compared and timed."""
    rng = np.random.default_rng(2)
    grid = {"points": grid_cloud(rng, B, N),
            "features": rng.random((B, N, 3)).astype(np.float32),
            "labels": rng.integers(0, NUM_CLASSES, (B, N)).astype(np.int32)}
    max_err = {name: 0.0 for name in WRAPPERS}
    with recording() as calls:
        train["step"](grid)
        torch.cuda.synchronize()
    with torch.no_grad():
        for name, cs in calls.items():
            for c in cs:
                max_err[name] = max(max_err[name], compare_call(name, c, exact_topk=True))
            print(f"  integer grid: {len(cs)} {name} calls agree", flush=True)
    del calls
    summary = time_calls(train["calls"], dev, train["launches"], max_err, TRAIN_KERNELS, reps=5)
    time_spread(train["calls"], dev,
                ("window_topk", "window_gather", "window_gather_bwd", "cbl_stats_fwd",
                 "cbl_stats_bwd"))
    return summary


def check_stale_kernels(dev, stale) -> list:
    """Phase 11: every pt_attn call of the recorded stale step against the
    plain versions; one stale step on integer-grid clouds, each of its
    backward calls also exact on integer cotangents; then each call of the
    recorded step timed as in phase 4."""
    max_err = {name: 0.0 for name in ("pt_attn_fwd", "pt_attn_bwd")}
    rng = np.random.default_rng(3)
    grid = {"points": grid_cloud(rng, B, N),
            "features": rng.random((B, N, 3)).astype(np.float32),
            "labels": rng.integers(0, NUM_CLASSES, (B, N)).astype(np.int32)}
    with recording() as calls:
        stale["step"](grid)
        torch.cuda.synchronize()
    with torch.no_grad():
        for name in max_err:
            for c in calls[name]:
                max_err[name] = max(max_err[name], compare_call(name, c))
        for c in calls["pt_attn_bwd"]:
            check_pt_attn_bwd_exact(c)
    print(f"  integer grid: {len(calls['pt_attn_fwd'])} pt_attn_fwd and "
          f"{len(calls['pt_attn_bwd'])} pt_attn_bwd calls agree, dkv exact on integer "
          f"cotangents", flush=True)
    del calls
    records = []
    summary = time_calls(stale["calls"], dev, stale["launches"], max_err, tuple(max_err), reps=5,
                         records=records)
    print_widths(records)
    time_spread(stale["calls"], dev, tuple(max_err))
    return summary


def print_widths(records) -> None:
    """The attention kernels' recorded launch times summed per width (C, M,
    K): launches, kernel ms, bound ms."""
    widths = {}
    for name, shape, t_k, bnd in records:
        w = widths.setdefault((name, shape["C"], shape["M"], shape["K"]), [0, 0.0, 0.0])
        w[0] += 1
        w[1] += t_k
        w[2] += bnd
    for (name, c, m, k), (n, t_k, bnd) in sorted(widths.items()):
        print(f"  {name} C={c} M={m} K={k}: {n} launches, {t_k:.4f} ms, bound {bnd:.5f} ms "
              f"({t_k / bnd:.1f}x)", flush=True)


def attn_inputs(dev, rng, c, m, k, tile, width):
    """Seeded operands of one attention call at B clouds: tower arrays about
    as the folded flagship's (bn scales near 1), slot 0 the query row, the
    slots beyond the largest power of two <= K shadow slots in every row (so
    that the valid slots' equal weights are dyadic where W4 = 0, as
    check_pt_attn_bwd_exact needs), and a cotangent."""
    cs = c // pa.SHARES
    w_sz = tile * width

    def a(shape, scale=0.3, off=0.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale + off).astype(np.float32),
                               device=dev)

    params = (a((3, 3)), a((1, 3)), a((3, c)), a((1, c)), a((1, c), off=1.0), a((1, c)),
              a((c, cs), c ** -0.5), a((1, cs)), a((1, cs), off=1.0), a((1, cs)),
              a((cs, cs), cs ** -0.5), a((1, cs)))
    starts = window_starts(m // tile, width)
    li = rng.integers(0, w_sz, (B, m, k)).astype(np.int32)
    li[:, :, 0] = (np.arange(m) - np.repeat(starts * tile, tile))[None]
    li[:, :, 1 << (k.bit_length() - 1):] = w_sz
    args = (a((B, m, c), 1.0), a((B, m, 2 * c), 1.0), a((B, m, k, 3), 0.05),
            torch.as_tensor(li, device=dev), torch.as_tensor(starts, dtype=torch.int32, device=dev),
            tile, width, params)
    return args, a((B, m, c), 1.0)


# direct v2 calls of phase plan-shapes: (C, M, K, tile, width, window, labels)
# with labels "mixed" (4 classes, 10% of the rows without a label), "all"
# (every row in the loss mask: slot 0 the query, slot 1 a row of the other
# label) or "none" (one label: no row in the mask)
V2_SHAPES = (
    (1, 4096, 35, 256, 3, 1, "mixed"), (20, 4096, 35, 256, 3, 1, "mixed"),
    (33, 4096, 35, 256, 3, 1, "mixed"), (64, 4096, 1, 256, 3, 1, "mixed"),
    (128, 4096, 300, 256, 3, 1, "mixed"), (32, 4096, 300, 256, 3, 1, "all"),
    (32, 8192, 35, 128, 5, 2, "mixed"), (32, 8192, 35, 1024, 1, 0, "all"),
    (32, 4096, 35, 256, 3, 1, "none"),
    # M·K >= 2^23, and a support tile's slot range beyond the scatter's 2^22
    (32, 32768, 300, 4096, 4, 1, "mixed"),
)


def v2_inputs(dev, rng, c, m, k, tile, width, window, labels):
    """Seeded operands of a direct v2 call at B clouds → (features, meta,
    li, temperature, tile, width, window) and a cotangent g [B]."""
    w_sz = tile * width
    q = np.arange(m)
    own = q - np.repeat(cd.self_window_starts(m, tile, width, window) * tile, tile)
    if labels == "mixed":
        lab = rng.integers(0, 4, (B, m))
        valid = rng.random((B, m)) >= 0.1
    else:
        lab = np.broadcast_to(q % 2 if labels == "all" else 0 * q, (B, m))
        valid = np.ones((B, m), bool)
    onehot = np.eye(4, dtype=np.float32)[lab] * valid[..., None]
    li = rng.integers(0, w_sz + 1, (B, m, k)).astype(np.int32)
    if labels == "all":
        li[:, :, 0] = own
        li[:, :, 1] = np.where(own + 1 < w_sz, own + 1, own - 1)
    t = lambda a: torch.as_tensor(a, device=dev)
    features = t(rng.standard_normal((B, m, c), dtype=np.float32))
    args = (features, cd.row_meta(t(onehot)), t(li), 0.5, tile, width, window)
    return args, t(rng.standard_normal(B).astype(np.float32))


def check_v2_shapes(dev, rng) -> None:
    """The v2 kernels at V2_SHAPES against their plain versions, as in phase
    cbl-kernels: every shape the previous kernels took has a plan."""
    for c, m, k, tile, width, window, labels in V2_SHAPES:
        args, g = v2_inputs(dev, rng, c, m, k, tile, width, window, labels)
        stats = c2.cbl_tile2_fwd(*args)
        n_mask = int(stats[..., 6].sum())
        if labels == "all":
            require(n_mask == B * m, f"v2 C={c} M={m} K={k}: {n_mask} masked rows, not all")
        if labels == "none" or k == 1:
            require(n_mask == 0, f"v2 C={c} M={m} K={k}: {n_mask} masked rows, not none")
        err = compare_tile_stats("cbl_tile2_fwd", (args, {}, stats))
        bwd_args = args[:3] + (stats, g) + args[3:]
        dx = c2.cbl_tile2_bwd(*bwd_args)
        require(dx.shape == args[0].shape, f"v2 gradient {tuple(dx.shape)}")
        err = max(err, compare_tile_grad("cbl_tile2_bwd", (bwd_args, {}, dx)))
        plan = c2.bwd_plan(B, m, k, c, tile)
        print(f"  cbl_tile2 C={c} M={m} K={k} tile {tile} x width {width} ({labels}, {n_mask} "
              f"masked rows): fwd plan {tuple(c2.fwd_plan(B, m, k, c))}, scatter rows "
              f"{plan.scatter_rows}: max|d| {err:.3g}, the same bits twice", flush=True)
        del args, stats, dx
        torch.cuda.empty_cache()


# direct v1 calls of phase plan-shapes: (C, ncls, K), M = 4096, tile 256 x
# width 3, window 1, soft labels in halves (ties among the label columns), 10%
# of the rows without a label; ncls = 1 gives one class and no masked row
V1_SHAPES = ((1, 13, 35), (32, 1, 35), (32, 40, 35), (33, 13, 1), (33, 40, 35),
             (128, 13, 35), (128, 40, 1), (32, 13, 1))


def check_v1_shapes(dev, rng) -> None:
    """v1 at V1_SHAPES against its plain version, as in phase cbl-kernels
    (compare_tile_stats, compare_tile_grad): the split takes any ncls and
    every C the plans take."""
    m, tile, width, window = 4096, 256, 3, 1
    for c, ncls, k in V1_SHAPES:
        lab = rng.integers(0, 3, (B, m, ncls)).astype(np.float32) / 2
        lab[rng.random((B, m)) < 0.1] = 0.0
        feats = rng.standard_normal((B, m, c), dtype=np.float32)
        fused = torch.as_tensor(np.concatenate([lab, feats], -1), device=dev)
        li = torch.as_tensor(rng.integers(0, tile * width + 1, (B, m, k)).astype(np.int32),
                             device=dev)
        g = torch.as_tensor(rng.standard_normal(B).astype(np.float32), device=dev)
        args = (fused, li, ncls, 0.5, tile, width, window)
        stats = c1.cbl_tile_fwd(*args)
        n_mask = int(stats[..., 6].sum())
        if ncls == 1 or k == 1:
            require(n_mask == 0, f"v1 C={c} ncls={ncls} K={k}: {n_mask} masked rows, not none")
        err = compare_tile_stats("cbl_tile_fwd", (args, {}, stats))
        bwd_args = (fused, li, stats, g) + args[2:]
        dfused = c1.cbl_tile_bwd(*bwd_args)
        require(dfused.shape == fused.shape, f"v1 gradient {tuple(dfused.shape)}")
        err = max(err, compare_tile_grad("cbl_tile_bwd", (bwd_args, {}, dfused)))
        plan = c1.launch_plan(B, m, k, ncls + c, ncls, tile)
        print(f"  cbl_tile C={c} ncls={ncls} M={m} K={k} ({n_mask} masked rows): fwd plan "
              f"{tuple(plan.pass1)}, scatter rows {plan.scatter_rows}: max|d| {err:.3g}, the same "
              f"bits twice, the feature gradient v2's bits", flush=True)


def check_plan_shapes(dev) -> None:
    """Phase 15: direct calls at the shapes whose plans take a smaller tile
    or slot chunks, against the plain versions: pt_attn_fwd and pt_attn_bwd
    at C = 512 with K = 8 (M = 1024) and K = 32 and 48 (M = 256) as in
    phase 11 (1e-4 of scale, the forward's bits twice, dkv exact on integer
    cotangents); cbl_stats_fwd on windows wider than shared memory holds
    (width 7 x tile 256 and width 3 x tile 1024, K = 36) as in phase 9
    (counts exact, sums rel 1e-5, the same bits twice), and its L2 path at
    the flagship's level-0 window equal bit for bit to the staged path;
    cbl_tile2_fwd and cbl_tile2_bwd at V2_SHAPES (C in {1, 20, 32, 33, 64,
    128}, K in {1, 35, 300}, M·K >= 2^23, tile x width 128 x 5 and 1024 x
    1, every row and no row in the loss mask) as in phase 14; and v1 at
    V1_SHAPES (C in {1, 32, 33, 128}, ncls in {1, 13, 40}, K in {1, 35}) as
    in phase 14."""
    rng = np.random.default_rng(6)
    with torch.no_grad():
        for m, k, tile, width in ((1024, 8, 256, 3), (256, 32, 256, 1), (256, 48, 256, 1)):
            args, g = attn_inputs(dev, rng, 512, m, k, tile, width)
            fwd = (args, {}, pa.pt_attn_fwd(*args))
            bwd = (args + (g,), {}, pa.pt_attn_bwd(*args, g))
            err = max(compare_pt_attn_fwd(fwd), compare_pt_attn_bwd(bwd))
            check_pt_attn_bwd_exact(bwd)
            print(f"  pt_attn C=512 M={m} K={k}: fwd plan {tuple(pa.fwd_plan(B, m, k, 512))}, "
                  f"bwd plan {tuple(pa.bwd_plan(B, m, k, 512))}: max|d| {err:.3g}, dkv exact",
                  flush=True)
        labels = torch.as_tensor(rng.integers(0, NUM_CLASSES, (B, N)), device=dev)
        onehot = torch.nn.functional.one_hot(labels, NUM_CLASSES).float()
        onehot[torch.as_tensor(rng.random((B, N)) < 0.1, device=dev)] = 0.0
        meta = cd.row_meta(onehot)
        features = torch.as_tensor(rng.standard_normal((B, N, cd.CHANNELS), dtype=np.float32),
                                   device=dev)
        for k, tile, width, window in ((36, 256, 7, 3), (36, 1024, 3, 1), (35, 256, 3, 1)):
            w_sz = tile * width
            li = torch.as_tensor(rng.integers(0, w_sz + 1, (B, N, k)).astype(np.int32), device=dev)
            args = (features, meta, li, 1.0, tile, width, window)
            out = cd.cbl_stats_fwd(*args)
            err = compare_stats_fwd((args, {}, out))
            plan = cd.fwd_plan(B, N, k, tile, width)
            if plan[2]:  # a staged window: the L2 path gives its bits
                other = torch.empty_like(out)
                blocks, threads, _ = plan
                build.check(build.library().cbl_stats_fwd(
                    features.data_ptr(), meta.data_ptr(), li.data_ptr(), other.data_ptr(), B, N,
                    k, cd.CHANNELS, tile, width, window, cd._inv_t(1.0), blocks, threads, 0,
                    torch.cuda.current_stream(dev).cuda_stream), "cbl_stats_fwd")
                require(torch.equal(other.view(torch.int32), out.view(torch.int32)),
                        f"cbl_stats_fwd W={w_sz}: the L2 path's bits differ from the staged path's")
            print(f"  cbl_stats_fwd K={k} W={w_sz}: plan {plan}, max|d| {err:.3g}, the same bits "
                  f"twice{', and through L2' if plan[2] else ''}", flush=True)
        del features, meta, labels, onehot
        torch.cuda.empty_cache()
        check_v2_shapes(dev, rng)
        check_v1_shapes(dev, rng)


def check_routes(metrics: dict) -> None:
    """Phase 13: the CBL losses of one step on the same weights and batch
    on the dense and v2 routes against the XLA tile route's, each stage
    within the tolerance the CPU tests state for the pair."""
    for route, rtol in ROUTE_RTOL.items():
        rels = {k: abs(metrics[route][k] - metrics["xla"][k]) / abs(metrics["xla"][k])
                for k in ["cbl"] + [f"cbl_stage{i}" for i in range(STAGES)]}
        print(f"CBL losses, {route} route vs the XLA tile route: "
              + ", ".join(f"{k} {metrics[route][k]:.7f} vs {metrics['xla'][k]:.7f} "
                          f"(rel {v:.3g})" for k, v in rels.items()), flush=True)
        require(all(v <= rtol for v in rels.values()),
                f"the {route} route's CBL losses are not within rel {rtol} of the XLA route's")


def bare_entry(name, args, kw):
    """A kernel's C entry on operands prepared once, outside the timed call:
    none of the wrapper's host work (operand checks and conversions, the
    window starts copied to the card, the output allocated, the parameter
    gradients' and statistics' partial rows summed) is timed. The attention
    backward's dk|dv is not zeroed between runs. The returned call keeps
    its operands alive."""
    lib, stream = build.library(), torch.cuda.current_stream(args[0].device).cuda_stream

    def call(entry, tensors, *rest):
        ptrs = [t.data_ptr() for t in tensors]
        return lambda _keep=tensors: build.check(entry(*ptrs, *rest, stream), name)

    if name == "window_topk":
        query, support, k = args
        b, m, _ = query.shape
        ns, tile = support.shape[1], kw["tile"]
        idx = torch.empty((b, m, k), dtype=torch.int32, device=query.device)
        val = torch.empty((b, m, k), dtype=torch.float32, device=query.device)
        return call(lib.cbl_win_topk, (query, support, idx, val), b, m, ns, k, tile,
                    kw["width"], kw["window"], ns // tile, wt.MODES[kw.get("mode", "plain")],
                    int(kw.get("last_ties", False)))
    if name == "window_gather":
        x, li, starts, tile, width = args
        b, ns, c = x.shape
        m, k = li.shape[1:]
        out = torch.empty((b, m, k, c), dtype=x.dtype, device=x.device)
        eb = x.element_size()
        plan = tg.gather_plan(b * m * k, c, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0,
                              eb)
        ops = (x, li.to(torch.int32).contiguous(), starts.to(torch.int32).contiguous(), out)
        return call(lib.cbl_window_gather, ops, b, ns, m, k, c, tile, width, plan.lpg, plan.nt,
                    plan.rw, eb)
    if name == "window_gather_bwd":
        g, li, starts, tile, width, ns = args
        b, m, k, c = g.shape
        dx = torch.empty((b, ns, c), dtype=g.dtype, device=g.device)
        ops = (g, li.to(torch.int32).contiguous(), starts.to(torch.int32).contiguous(), dx)
        return call(lib.cbl_window_gather_bwd, ops, b, ns, m, k, c, tile, width, g.element_size())
    if name == "cbl_stats_fwd":
        features, meta, li, temperature, tile, width, window = args
        f, mt, lii = cd._cuda_args(features, meta, li, tile, width)
        b, m, c = f.shape
        k = lii.shape[-1]
        ops = (f, mt, lii, torch.empty((b, m, 8), dtype=torch.float32, device=f.device))
        return call(lib.cbl_stats_fwd, ops, b, m, k, c, tile, width, window,
                    cd._inv_t(temperature), *cd.fwd_plan(b, m, k, tile, width))
    if name in ("pt_attn_fwd", "pt_attn_bwd"):
        q, kv, rel, li, starts, tile, width, params = args[:8]
        (q, kv, rel, li, st), ps, (b, m, k, c, cs_) = pa._cuda_args(
            q, kv, rel, li, starts, tile, width, params)
        ptrs = pa._pointers(ps)
        head = (q.data_ptr(), kv.data_ptr(), rel.data_ptr(), li.data_ptr(), st.data_ptr(),
                ctypes.cast(ptrs, ctypes.c_void_p))
        if name == "pt_attn_fwd":
            plan = pa.fwd_plan(b, m, k, c)
            out = (torch.empty_like(q), torch.empty((plan.blocks, 2 * c + 2 * cs_), device=q.device))
            entry = lib.cbl_pt_attn_fwd
        else:  # g_out in q's dtype; dq and dk|dv float32 (the wrapper casts them after)
            plan = pa.bwd_plan(b, m, k, c)
            out = (args[8].to(q.dtype).contiguous(), torch.empty_like(q, dtype=torch.float32),
                   torch.zeros_like(kv, dtype=torch.float32),
                   torch.empty((plan.blocks, sum(pa._prow(c, cs_))), device=q.device))
            entry = lib.cbl_pt_attn_bwd
        ptr_args = head + tuple(t.data_ptr() for t in out)
        keep = (q, kv, rel, li, st, ps, ptrs, out)
        return lambda _keep=keep: build.check(entry(
            *ptr_args, b, m, k, c, tile, width, plan.blocks, plan.threads, plan.rows, plan.chunk,
            plan.smem, q.element_size(), stream), name)
    if name == "cbl_stats_bwd":
        features, meta, li, stats, g, temperature, tile, width, window = args
        f, mt, lii = cd._cuda_args(features, meta, li, tile, width)
        b, m, c = f.shape
        k = lii.shape[-1]
        coef = torch.empty((b, m, k), dtype=torch.float32, device=f.device)
        lands = torch.empty((b, m, k), dtype=torch.int32, device=f.device)
        ops = (f, mt, lii, stats.contiguous(), g.contiguous(), coef, lands, torch.empty_like(f))
        return call(lib.cbl_stats_bwd, ops, b, m, k, c, tile, width, window,
                    cd._inv_t(temperature), cd.bwd_plan(b, m, tile)[1])
    if name == "cbl_tile2_fwd":
        features, meta, li, temperature, tile, width, window = args
        b, m, c = features.shape
        f, mt, lii = c2.v2_operands(features, meta, li, tile, width)
        plan = c2.fwd_plan(b, m, lii.shape[-1], c)
        ops = (f, mt, lii, torch.empty((b, m, 8), device=f.device))
        return call(lib.cbl_tile2_fwd, ops, b, m, lii.shape[-1], plan.channels, tile, width,
                    window, float(temperature), plan.label_rows, plan.row_rows)
    if name == "cbl_tile2_bwd":
        features, meta, li, stats, g, temperature, tile, width, window = args
        b, m, c = features.shape
        f, mt, lii, st, gl = c2.v2_operands(features, meta, li, tile, width, stats, g)
        k = lii.shape[-1]
        plan = c2.bwd_plan(b, m, k, c, tile)
        scratch = (torch.empty((b, m, k), device=f.device),
                   torch.empty((b, m, k), dtype=torch.int32, device=f.device), torch.empty_like(f))
        return call(lib.cbl_tile2_bwd, (f, mt, lii, st, gl) + scratch, b, m, k,
                    plan.pass1.channels, tile, width, window, float(temperature),
                    plan.pass1.row_rows, plan.scatter_rows)
    if name in ("cbl_tile_fwd", "cbl_tile_bwd"):
        fused, li = args[:2]
        ncls = args[2] if name == "cbl_tile_fwd" else args[4]
        temperature, tile, width, window = args[-4:]
        b, m, columns = fused.shape
        k = li.shape[-1]
        plan = c1.launch_plan(b, m, k, columns, ncls, tile)
        empty = lambda *shape: torch.empty(shape, device=fused.device)
        split = (empty(b, m, plan.pass1.channels), empty(b, m, 8))  # features, meta
        dims = (b, m, k, columns - ncls, ncls, tile, width, window, float(temperature))
        lii = li.to(torch.int32).contiguous()
        if name == "cbl_tile_fwd":
            return call(lib.cbl_tile_fwd, (fused, lii) + split + (empty(b, m, 8),), *dims,
                        plan.pass1.label_rows, plan.pass1.row_rows)
        scratch = split + (empty(b, m, k), torch.empty((b, m, k), dtype=torch.int32,
                                                       device=fused.device),
                           empty(b, m, plan.pass1.channels), torch.empty_like(fused))
        return call(lib.cbl_tile_bwd, (fused, lii, args[2].contiguous(), args[3].contiguous())
                    + scratch, *dims, plan.pass1.row_rows, plan.scatter_rows)
    raise ValueError(f"no bare entry for {name}")


@torch.no_grad()
def time_spread(calls, dev, names, reps=20):
    """The spread of one launch's time: the largest recorded call of each
    kernel (level 0; window_topk by rows times k) timed reps times alone,
    each after an L2 flush, through its wrapper and through its bare C
    entry; for the dense and the v2 CBL backward, how their scatter's terms
    (slots with a coefficient != 0) spread over the support tiles, one
    block's work each at level 0."""
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for name in names:
        args, kw, _ = max(calls[name], key=lambda call: call[0][0].numel() * (
            call[0][2] if name == "window_topk" else 1))
        mod, attr, _ = WRAPPERS[name]
        for what, fn in (("wrapper", lambda: getattr(mod, attr)(*args, **kw)),
                         ("bare C entry", bare_entry(name, args, kw))):
            ts = sorted(time_ms(fn, flush_buf, reps=1) for _ in range(reps))
            print(f"  {name} {tuple(args[0].shape)} {kw}, {what}, {reps} runs: min {ts[0]:.4f} ms, median "
                  f"{statistics.median(ts):.4f} ms, max {ts[-1]:.4f} ms", flush=True)
        if name == "cbl_stats_bwd":
            features, meta, li, _, _, _, tile, width, window = args
            m = features.shape[1]
            starts = torch.as_tensor(cd.self_window_starts(m, tile, width, window), device=dev)
            rows, member = tg._rows(li, starts, tile, width, m)
            hit = member & (cd.cbl_bwd_cd_plain(*args)[0] != 0)
            per_tile = torch.bincount(rows[hit] // tile, minlength=features.shape[0] * m // tile)
            print(f"  {name} {tuple(features.shape)}: {int(hit.sum())} scatter terms on "
                  f"{per_tile.numel()} support tiles, per tile min {int(per_tile.min())}, mean "
                  f"{float(per_tile.float().mean()):.1f}, max {int(per_tile.max())}", flush=True)
        if name == "cbl_tile2_bwd":
            features, meta, li, stats, g, temperature, tile, width, window = args
            coef, rows = c2.grad_coefs_plain(features, meta[..., 0], meta[..., 1], li, stats,
                                             g, temperature, tile, width, window)
            per_tile = torch.bincount(rows[coef != 0] // tile,
                                      minlength=features.shape[0] * features.shape[1] // tile)
            print(f"  {name} {tuple(features.shape)}: {int((coef != 0).sum())} scatter terms on "
                  f"{per_tile.numel()} support tiles, per tile min {int(per_tile.min())}, mean "
                  f"{float(per_tile.float().mean()):.1f}, max {int(per_tile.max())}", flush=True)


def check_cbl_kernels(dev, pallas) -> list:
    """Phase 14: every v2 call of the recorded cbl-pallas step against its
    plain version and timed; v1 at that step's level-0 shape ([its soft
    labels | its latents], K = 35) against its plain version, as v2 is
    held, and against v2 on the same inputs, timed, and 20 times alone; gather_rows exact on x [131072, 128] f32 with
    131072 random rows, torch.index_select timed beside it. The launches
    of v1 and gather_rows are those of the cbl-pallas step (0: no path runs
    them); their direct calls here are counted apart."""
    names = ("cbl_tile2_fwd", "cbl_tile2_bwd", "cbl_tile_fwd", "cbl_tile_bwd", "gather_rows")
    max_err = {name: 0.0 for name in names}
    summary = time_calls(pallas["calls"], dev, pallas["launches"], max_err, names[:2], reps=5)
    time_spread(pallas["calls"], dev, names[:2])

    features, label_soft, li, temperature, tile, width, window = pallas["stage_inputs"][0]
    ncls = label_soft.shape[-1]
    fused = torch.cat([label_soft, features], -1).contiguous()
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(B), dtype=torch.float32,
                        device=dev)
    reset_counts()
    stats1 = c1.cbl_tile_fwd(fused, li, ncls, temperature, tile, width, window)
    dfused = c1.cbl_tile_bwd(fused, li, stats1, g, ncls, temperature, tile, width, window)
    torch.cuda.synchronize()
    direct = read_counts()
    meta = cd.row_meta(label_soft)
    stats2 = c2.cbl_tile2_fwd(features, meta, li, temperature, tile, width, window)
    dx2 = c2.cbl_tile2_bwd(features, meta, li, stats2, g, temperature, tile, width, window)
    sums1, sums2 = stats1[..., 5].sum(-1), stats2[..., 5].sum(-1)
    rel = float(((sums1 - sums2).abs() / sums2.abs()).max())
    print(f"  v1 vs v2 kernels at {tuple(fused.shape)}, K={li.shape[-1]}: loss sums "
          f"{sums1.tolist()} vs {sums2.tolist()} (rel {rel:.3g})", flush=True)
    require(torch.equal(stats1[..., [3, 4, 6]], stats2[..., [3, 4, 6]]), "v1 and v2 counts differ")
    require(rel <= 1e-5, "v1 and v2 loss sums differ")
    compare_scaled("v1 vs v2 feature gradient", dfused[..., ncls:], dx2, 1e-4)
    v1_calls = {
        "cbl_tile_fwd": [((fused, li, ncls, temperature, tile, width, window), {}, stats1)],
        "cbl_tile_bwd": [((fused, li, stats1, g, ncls, temperature, tile, width, window), {},
                          dfused)],
    }
    summary += time_calls(v1_calls, dev, pallas["no_path"], max_err, names[2:4], reps=5)
    time_spread(v1_calls, dev, names[2:4])

    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((131072, 128), dtype=np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, 131072, 131072, dtype=np.int32), device=dev)
    reset_counts()
    out = gd.gather_rows(x, idx)
    direct["gather_rows"] = read_counts()["gather_rows"]
    require(torch.equal(out, x[idx.long()]), "gather_rows differs from x[idx]")
    print(f"  gather_rows {tuple(out.shape)}: equal to x[idx]", flush=True)
    summary += time_calls({"gather_rows": [((x, idx), {}, out)]}, dev, pallas["no_path"],
                          max_err, names[4:])
    for entry in summary[2:]:  # no path runs them: launches made here
        entry["direct_launches"] = direct[entry["name"]]
    return summary


def require_bf16_counts(by_dtype: dict, expect: dict, what: str) -> None:
    """The launches of each kernel in ``expect`` by dtype, exactly."""
    for name, want in expect.items():
        got = {k: by_dtype[name][k] for k in want}
        require(got == want, f"{name} in {what}: launches by dtype {got}, not {want}")


def bf16_calls_on_host(calls: dict, names) -> dict:
    """The bfloat16 calls of ``names`` among a step's recorded calls, moved
    to host memory: the later phases' peak memory does not count them."""
    return frozen({name: split_bf16(calls)[name] for name in names}, torch.device("cpu"))


def check_bf16_kernels(dev, host_calls, launches) -> list:
    """Phase 19: the bfloat16 calls of the recorded bf16 steps (the gathers
    of phase 17's, the attention of phase 18's; kept in host memory until
    now) against the plain versions and timed as in phase 4; the bounds from
    the bfloat16 bytes."""
    calls = frozen(host_calls, dev)
    names = tuple(BF16_KERNELS)
    for name in names:
        require(len(calls[name]) == launches[name], f"{name}: {len(calls[name])} recorded calls, "
                f"{launches[name]} launches")
    with torch.no_grad():
        for c in calls["pt_attn_bwd_bf16"]:
            check_pt_attn_bwd_exact(c)
    max_err = {name: 0.0 for name in names}
    records = []
    summary = time_calls(calls, dev, launches, max_err, names, reps=5, records=records)
    print_widths([r for r in records if r[0].startswith("pt_attn")])
    time_against_f32(calls, dev, names)
    return summary


def as_f32(call):
    """A bfloat16 call's float32 twin: its bfloat16 operands (x, g, q, kv,
    g_out) widened exactly, the backward's dx dtype float32."""
    args, kw, _ = call
    widen = lambda t: t.float() if isinstance(t, torch.Tensor) and t.dtype == BF16 else t
    return tuple(widen(a) for a in args), {k: torch.float32 if v is BF16 else v
                                           for k, v in kw.items()}


@torch.no_grad()
def time_against_f32(calls, dev, names, reps=5) -> None:
    """Each bfloat16 call and its float32 twin through the same wrapper,
    timed in turns (f32, bf16, bf16, f32; L2 flushed, mean of ``reps``
    each), summed over the calls: what the element type alone changes."""
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for name in names:
        mod, attr, _ = WRAPPERS[base(name)]
        fn = getattr(mod, attr)
        tot = {"f32": 0.0, "bf16": 0.0}
        for call in calls[name]:
            args, kw = call[0], call[1]
            args32, kw32 = as_f32(call)
            for what, a, k in (("f32", args32, kw32), ("bf16", args, kw), ("bf16", args, kw),
                               ("f32", args32, kw32)):
                tot[what] += time_ms(lambda: fn(*a, **k), flush_buf, reps) / 2
        print(f"  {name} on the same {len(calls[name])} calls in turns: bfloat16 {tot['bf16']:.4f} "
              f"ms, float32 {tot['f32']:.4f} ms ({tot['bf16'] / tot['f32']:.3f}x)", flush=True)


def serve(dev, batch, bn_mode="batch", ref_probs=None, dtype=torch.float32) -> dict:
    """Phases 3, 7, 16 and 18: the checkpoint served with flax batch BN or
    stale BN, float32 or bfloat16, on one B x N batch: one request with the
    launch counts reset just before and read just after (each kernel of the
    path > 0) and its calls recorded, the running statistics untouched,
    three timed requests, probs against the plain versions' (and against
    ``ref_probs`` where given: eval-mode BN is the same function in both
    modes), crop OA. A bfloat16 model's ``ref_probs`` are the float32
    model's on the same weights: their gap is the scale, and the kernels'
    probs are held within half of it of the plain versions' (argmax agreeing
    on >= 99.5% of points)."""
    kernels = SERVE_KERNELS if bn_mode == "batch" else STALE_SERVE_KERNELS
    bf16 = dtype == BF16
    model, trained = load_model(bn_mode, dtype)
    step = make_eval_step(model, PyramidSpec(), device=dev, num_classes=NUM_CLASSES)

    def predict(bt):
        probs, _ = step(bt)
        return probs.cpu().numpy()

    before = buffers(model)
    predict(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    with recording() as calls:
        probs, conf = step(batch)
        torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if k in kernels}
    by_dtype = read_dtype_counts()
    print(f"launches in one request ({bn_mode} BN{', bfloat16' if bf16 else ''}): {launches}, "
          f"by dtype {by_dtype}", flush=True)
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    require(bool(torch.isfinite(probs).all()) and probs.shape == (B, N, NUM_CLASSES),
            f"probs {tuple(probs.shape)} not finite")
    require(all(torch.equal(v, before[k]) for k, v in buffers(model).items()),
            "a request changed the running statistics")

    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        predict(batch)
        lat.append(time.perf_counter() - t0)
    med, peak = statistics.median(lat), torch.cuda.max_memory_allocated()
    print(f"request latency ({bn_mode} BN{', bfloat16' if bf16 else ''}) median {med * 1e3:.3f} "
          f"ms over {[round(x * 1e3, 3) for x in lat]}, {B * N / med:.1f} points/s, "
          f"max_memory_allocated {peak} B", flush=True)

    with plain_kernels():
        p_plain, _ = step(batch)
    if bf16:
        require(ref_probs is not None, "a bfloat16 request needs the float32 model's probs")
        gap = float((probs - ref_probs).abs().max())
        agree32 = float((probs.argmax(-1) == ref_probs.argmax(-1)).float().mean())
        d = float((probs - p_plain).abs().max())
        agree = float((probs.argmax(-1) == p_plain.argmax(-1)).float().mean())
        print(f"kernels vs plain versions (bfloat16): max|dprobs| {d:.3g}, argmax agreement "
              f"{agree:.6f}; bfloat16 vs float32 model, same weights: max|dprobs| {gap:.3g}, "
              f"argmax agreement {agree32:.6f}", flush=True)
        require(d <= 0.5 * gap and agree >= 0.995, "bfloat16 probs disagree with the plain versions")
        refs = {}
    else:
        refs = {"plain versions": p_plain}
        if ref_probs is not None:
            refs["batch-BN model"] = ref_probs
    for what, ref in refs.items():
        d = float((probs - ref).abs().max())
        agree = float((probs.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"kernels vs {what}: max|dprobs| {d:.3g}, argmax agreement {agree:.6f}", flush=True)
        require(d <= 1e-3 and agree >= 0.999, f"probs disagree with the {what}")
    conf = conf.cpu().numpy()
    oa = float(np.trace(conf) / conf.sum())
    print(f"crop OA {oa:.4f} ({'trained' if trained else 'random'} weights)", flush=True)
    if trained:
        require(oa >= 0.5, f"crop OA {oa:.4f} < 0.5")
    return dict(step=step, predict=predict, calls=calls, launches=launches, probs=probs, med=med,
                peak=peak, by_dtype=by_dtype)


def voting(predict, what="request", steps=3) -> None:
    """Phase 6: VotingEvaluator over room 0 for ``steps`` requests."""
    ev = VotingEvaluator(room0(), predict, NUM_CLASSES, N, batch_size=B,
                         voxel_size=0.04, num_votes=20, seed=0)
    t0 = time.perf_counter()
    m = ev.run(max_steps=steps)
    per = (time.perf_counter() - t0) / steps
    print(f"voting: {per * 1e3:.3f} ms per {what} over {steps} requests "
          f"(sub mIoU so far {m['sub']['mIoU']:.4f})", flush=True)


def eval_features(dev, batch, served: dict, bn_mode="batch", dtype=torch.float32,
                  f32_feats=None) -> dict:
    """Phases 20 and 23: make_eval_step(output='logits', with_features=True)
    on the checkpoint and phase serve's batch (``served``: the probs and
    launches of phase serve, or of phase stale-serve under stale BN, or of
    the bfloat16 requests of phases bf16-serve and bf16-stale): one request
    with the counts reset just before and read just after (as the served
    request's), softmax(logits) within 1e-6 of the served probs (bfloat16:
    max |d| 0) with the same argmax, each latent [B, N, d] finite in the
    caller's row order; float32: the logits and every latent within 1e-3 of
    their scale of the plain versions'; bfloat16: the RMS of every latent's
    difference from the plain versions' within half of the RMS of the
    bfloat16-vs-float32 gap (``f32_feats``: the float32 model's latents on
    the same weights and batch, the gap's other side), or within twice the
    floor that sum order alone sets: the RMS of the plain versions' latents
    against the same with the fused attention's slots reversed
    (``reversed_slots``: the same function, its sums over the slots in
    another order). The RMS, as the CPU tests of the stale bfloat16 model
    take it: under stale BN the fused attention sums in another order than
    its plain version, an output at a bfloat16 rounding boundary rounds one
    ulp apart, and 18 layers spread the flips, so single latent elements can
    differ by as much as the gap's largest element (latent2 of the stale
    model on the H100: 0.0315 against 0.0315) and latent1's RMS reached
    0.53 of the gap's. Returns the model, the launches and the latents on
    the host."""
    bf16 = dtype == BF16
    model, _ = load_model(bn_mode, dtype)
    step = make_eval_step(model, PyramidSpec(), device=dev, num_classes=NUM_CLASSES,
                          output="logits", with_features=True)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    logits, _, feats = step(batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in read_counts().items() if k in served["launches"]}
    what = f"{bn_mode} BN" + (", bfloat16" if bf16 else "")
    by_dtype = read_dtype_counts()
    print(f"feature request ({what}): launches {launches}, by dtype {by_dtype}, {ms:.3f} ms on "
          f"the host clock", flush=True)
    require(launches == served["launches"],
            f"launches {launches} differ from the served request's {served['launches']}")
    if bf16:
        require(by_dtype == served["by_dtype"],
                f"launches by dtype {by_dtype} differ from the served request's")
    probs = torch.softmax(logits, -1)
    d = float((probs - served["probs"]).abs().max())
    print(f"softmax(logits) vs the served probs: max|d| {d:.3g}", flush=True)
    require(d == 0 if bf16 else d <= 1e-6, "softmax(logits) differs from the served probs")
    require(torch.equal(probs.argmax(-1), served["probs"].argmax(-1)),
            "softmax(logits) and the served probs disagree on an argmax")
    require(logits.shape == (B, N, NUM_CLASSES), f"logits {tuple(logits.shape)}")
    for k, v in feats.items():
        require(v.shape[:2] == (B, N) and bool(torch.isfinite(v).all()),
                f"{k} {tuple(v.shape)} not finite")
    with plain_kernels():
        p_logits, _, p_feats = step(batch)
    require(sorted(feats) == sorted(p_feats), "the plain step gave other latents")
    host = {k: v.cpu() for k, v in feats.items()}
    if bf16:
        require(sorted(host) == sorted(f32_feats), "the float32 model gave other latents")
        floor_feats = {}
        if "pt_attn_fwd" in launches:
            with plain_kernels(), mock.patch.object(pa, "pt_attn_fwd", reversed_slots):
                _, _, floor_feats = step(batch)
        errs = {}
        rms = lambda d: float(d.double().square().mean().sqrt())
        for k in sorted(host):
            d, g = host[k] - p_feats[k].cpu(), host[k] - f32_feats[k]
            err, gap = rms(d), rms(g)
            floor = rms(p_feats[k].cpu() - floor_feats[k].cpu()) if floor_feats else 0.0
            print(f"  {k} {tuple(host[k].shape)}: kernels vs plain RMS {err:.3g} (max|d| "
                  f"{float(d.abs().max()):.3g}), {err / gap:.3f} of the bfloat16 vs float32 "
                  f"model's RMS {gap:.3g} (max|d| {float(g.abs().max()):.3g}); the plain "
                  f"version against itself with the attention's slots reversed RMS {floor:.3g}",
                  flush=True)
            require(err <= max(0.5 * gap, 2.0 * floor),
                    f"{k}: kernels vs plain RMS {err:.3g} > half the gap's {gap:.3g} and > twice "
                    f"the slot-order floor {floor:.3g}")
            errs[k] = err
    else:
        errs = {"logits": compare_scaled("logits", logits, p_logits, 1e-3)}
        for k in sorted(feats):
            errs[k] = compare_scaled(k, feats[k], p_feats[k], 1e-3)
    print(f"latents {', '.join(f'{k} {tuple(v.shape)}' for k, v in sorted(feats.items()))}; "
          f"kernels vs plain versions max|d|: "
          f"{', '.join(f'{k} {v:.3g}' for k, v in errs.items())}", flush=True)
    return dict(model=model, launches=launches, feats=host)


def reversed_slots(q, kv, rel, li, starts, tile, width, params):
    """pt_attn_plain with every row's K slots in reverse order: the same
    function (a softmax and a sum over the slots), its float32 sums over the
    slots taken in another order."""
    rev = torch.arange(li.shape[2] - 1, -1, -1, device=li.device)
    return pa.pt_attn_plain(q, kv, rel[:, :, rev], li[:, :, rev], starts, tile, width, params)


def voting_features(dev, model, max_steps=40) -> None:
    """Phase 21: run_voting_eval over room 0 with the feature step
    (num_votes 1.0, at most ``max_steps`` requests), then run_boundary_suite
    with 'boundary-stat-feature' on the voted cloud: B-IoU finite in [0, 1],
    every latent's l2, cos and norml2 distances finite."""
    ctx = {}
    t0 = time.perf_counter()
    m = run_voting_eval(model, PyramidSpec(), room0(), num_classes=NUM_CLASSES, n_points=N,
                        batch_size=B, voxel_size=0.04, num_votes=1.0, extra_ops="feature",
                        max_steps=max_steps, device=dev, ctx=ctx, log=lambda *_: None)
    t_vote = time.perf_counter() - t0
    ev = ctx["evaluator"]
    cs = ev.clouds[0]
    print(f"voting with features: {ev.requests} requests in {t_vote:.3f} s "
          f"({t_vote / ev.requests * 1e3:.3f} ms a request), {len(cs.coord)} points, final "
          f"min potential {cs.min_potential():.4f}, sub mIoU {m['sub']['mIoU']:.4f} OA "
          f"{m['sub']['OA']:.4f}, full mIoU {m['full']['mIoU']:.4f} OA {m['full']['OA']:.4f}",
          flush=True)
    require(len(cs.features) == len(model.planes), f"latents {sorted(cs.features)}")
    t0 = time.perf_counter()
    clouds = [{"coord": c.coord, "label": c.label, "prob": c.probs, "features": c.features}
              for c in ev.clouds]
    bm = run_boundary_suite(clouds, NUM_CLASSES, 0.1, "boundary-stat-feature",
                            log=lambda *_: None)
    br, st = bm["boundary"], bm["stat"]
    b_iou = br["B-IoU"]
    print(f"boundary suite in {time.perf_counter() - t0:.3f} s: B-IoU {b_iou:.4f}, "
          f"pct_err_on_bound_label {st['pct_err_on_bound_label']:.4f}", flush=True)
    require(np.isfinite(b_iou) and 0 <= b_iou <= 1, f"B-IoU {b_iou}")
    for k in sorted(cs.features):
        for kind in ("l2", "cos", "norml2"):
            d = br[f"dist_{k}:{kind}"]
            require(bool(np.isfinite(list(d.values())).all()), f"dist_{k}:{kind} {d}")
        d = br[f"dist_{k}:l2"]
        print(f"  dist_{k}:l2 pos {d['pos']:.4f} neg {d['neg']:.4f} bound "
              f"{d['bound_mean']:.4f} plain {d['plain_mean']:.4f}", flush=True)


def enumerate_room(dev, model, trained: bool) -> None:
    """Phase 22: run_enumerate_eval over room 0 (n_points N, voxel_max
    80000, B crops a request, 'boundary-stat'): every point covered, full OA
    >= 0.5 with the trained checkpoint; the eval step's time per request on
    the host clock and the room's seconds split into the eval step (launches
    and device, to a synchronize) and the rest (host numpy and copies)."""
    step = make_eval_step(model, PyramidSpec(), device=dev, num_classes=NUM_CLASSES,
                          output="logits")
    step_s = []

    def timed(bt):
        t0 = time.perf_counter()
        out = step(bt)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        return out

    ctx = {"eval_step": timed}
    t0 = time.perf_counter()
    m = run_enumerate_eval(model, PyramidSpec(), room0(), num_classes=NUM_CLASSES, n_points=N,
                           voxel_size=0.04, voxel_max=80000, batch_size=B,
                           extra_ops="boundary-stat", device=dev, ctx=ctx, log=lambda *_: None)
    total = time.perf_counter() - t0
    ev = ctx["evaluator"]
    counts = ev.pred_counts[0]
    oa = m["full"]["OA"]
    print(f"enumerate: {ev.passes[0]} passes, {ev.parts[0]} parts, {ev.requests} requests, "
          f"{len(counts)} points (each predicted {int(counts.min())}-{int(counts.max())} times); "
          f"eval step {statistics.median(step_s) * 1e3:.3f} ms a request (median on the host "
          f"clock); room {total:.3f} s = eval step {sum(step_s):.3f} s + host "
          f"{total - sum(step_s):.3f} s; full mIoU {m['full']['mIoU']:.4f} OA {oa:.4f} mACC "
          f"{m['full']['mACC']:.4f}; B-IoU {m['boundary']['B-IoU']:.4f}, pct_err_on_bound_label "
          f"{m['stat']['pct_err_on_bound_label']:.4f}", flush=True)
    require(bool((counts > 0).all()), "enumeration missed points")
    if trained:
        require(oa >= 0.5, f"enumerate full OA {oa:.4f} < 0.5")


def write_s3dis_rooms(root: Path) -> None:
    """Phase 24's dataset: ENTRY_ROOMS synthetic train rooms (Area_1_*) and
    one val room (Area_5_*) of ENTRY_POINTS points each, as S3DIS xyzrgbl
    .npy files."""
    for split, area, n in (("train", 1, ENTRY_ROOMS), ("val", 5, 1)):
        rooms = SyntheticSceneDataset(num_rooms=n, points_per_room=ENTRY_POINTS, seed=0,
                                      split=split)
        for i in range(n):
            c, f, lab = rooms.room(i)
            np.save(root / f"Area_{area}_room{i}.npy",
                    np.concatenate([c, f, lab[:, None]], 1).astype(np.float32))


def count_delta(after, before):
    """Launch counts (or nested counts by dtype) of ``after`` less ``before``."""
    if isinstance(after, dict):
        return {k: count_delta(v, before[k]) for k, v in after.items()}
    return after - before


class StepProbe:
    """Phases 24-25's instrumentation of the entry's train loop: ``prefetch``
    replaces main.py's prefetch (the real one, or with ``use_prefetch`` off
    the bare iterator in the loop's thread) and wraps its iterator in a
    utils/profiling.py::StepTimer: the wait for each batch, then the step
    ended by a synchronize, and the kernels each step launched (counts and
    counts by dtype, read before and after; the loop's own counts are
    never reset). ``peak``: max_memory_allocated at the end of the loop,
    before the epoch-end eval."""

    def __init__(self, use_prefetch: bool = True):
        self.use_prefetch = use_prefetch
        self.waits, self.steps, self.launches, self.by_dtype = [], [], [], []
        self.timer, self.peak = None, None

    def prefetch(self, factory, depth=2):
        it = entry_prefetch(factory, depth) if self.use_prefetch else factory()
        self.timer = StepTimer()
        t_end = time.perf_counter()
        for item in it:
            self.timer.data_ready()
            t_ready = time.perf_counter()
            self.waits.append(t_ready - t_end)
            counts, by_dtype = read_counts(), read_dtype_counts()
            yield item
            torch.cuda.synchronize()
            self.timer.step_done()
            t_end = time.perf_counter()
            self.steps.append(t_end - t_ready)
            self.launches.append(count_delta(read_counts(), counts))
            self.by_dtype.append(count_delta(read_dtype_counts(), by_dtype))
        self.peak = torch.cuda.max_memory_allocated()


def run_entry(argv, probe=None):
    """main.py's main(argv) with main.py's prefetch replaced by ``probe``'s
    (where given) and its setup recorded → (main's result, the setups'
    results, seconds, the launch counts of the whole run from 0)."""
    built = []

    def setup(*args, **kw):
        out = entry_setup(*args, **kw)
        built.append(out)
        return out

    with ExitStack() as stack:
        stack.enter_context(mock.patch.object(entry, "setup", setup))
        if probe is not None:
            stack.enter_context(mock.patch.object(entry, "prefetch", probe.prefetch))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = entry.main(argv)
        torch.cuda.synchronize()
        return out, built, time.perf_counter() - t0, read_counts()


def entry_losses(exp: Path) -> list:
    """The train losses main.py recorded, read with the port's read_scalars."""
    series = read_scalars(str(exp / "scalars.jsonl"))
    return series["train/loss"]


def print_probe(what: str, probe: StepProbe) -> float:
    med = statistics.median(probe.steps)
    print(f"{what}: {len(probe.steps)} steps, the wait for each batch "
          f"{[round(x * 1e3, 3) for x in probe.waits]} ms (median "
          f"{statistics.median(probe.waits) * 1e3:.3f}), step {[round(x * 1e3, 3) for x in probe.steps]}"
          f" ms (median {med * 1e3:.3f}), StepTimer {probe.timer.summary()}, "
          f"{B * N / med:.1f} points/s at the median, max_memory_allocated {probe.peak} B",
          flush=True)
    return med


def train_entry(dev, root: Path, batch, train_launches: dict) -> None:
    """Phase 24: the flagship trained through main.py from S3DIS .npy rooms,
    its snapshot read back by --mode val."""
    exp, exp_plain = root / "exp", root / "exp_no_prefetch"
    data = f"data.data_root:{root / 'data'}"
    print(f"main.py -c s3dis_pt_cbl --mode train --set {data};{ENTRY_SETS};{ENTRY_LOG}: full "
          f"width and depth from the flax-like init, default_train_transform, prefetch depth 3; "
          f"cuts: batch 16 -> 2, epochs 200 -> 1 (loop 30 -> 2: {ENTRY_ROOMS} rooms x 2 = "
          f"{ENTRY_ROOMS} steps of 2); log_freq 10 -> 1 reads every step's loss", flush=True)
    probe = StepProbe()
    best, built, secs, total = run_entry(
        ["-c", "s3dis_pt_cbl", "--mode", "train", "--set", f"{data};{ENTRY_SETS};{ENTRY_LOG}",
         "--exp_dir", str(exp)], probe)
    (model, _, _, opt, *_), = built
    med = print_probe("train-entry (prefetch)", probe)
    print(f"the whole run {secs:.3f} s (setup, {len(probe.steps)} steps, the epoch-end voting "
          f"eval, the snapshot); best full-cloud mIoU {best:.4f}; launches of the run {total}",
          flush=True)
    steps, losses = entry_losses(exp)
    print(f"losses {losses} at steps {steps}", flush=True)
    require(steps == list(range(1, ENTRY_ROOMS + 1)) and all(np.isfinite(losses)),
            f"losses {losses} at steps {steps}")
    require(all(total[k] > 0 for k in TRAIN_KERNELS), f"a kernel was not launched: {total}")
    for i, launches in enumerate(probe.launches):
        got = {k: launches[k] for k in TRAIN_KERNELS}
        require(got == train_launches, f"step {i}: launches {got}, phase train's {train_launches}")
    print(f"launches a step (each of the {len(probe.launches)}): "
          f"{ {k: probe.launches[0][k] for k in TRAIN_KERNELS} }, equal to phase train's",
          flush=True)
    snap, marker = exp / "checkpoints" / f"snap-{ENTRY_ROOMS}", exp / "checkpoints" / "best.json"
    require(snap.exists() and marker.exists(), "no snapshot or best.json")
    print(f"{snap.name}: {snap.stat().st_size} B; best.json {marker.read_text()}", flush=True)

    plain = StepProbe(use_prefetch=False)
    run_entry(["-c", "s3dis_pt_cbl", "--mode", "train", "--set",
               f"{data};{ENTRY_SETS};{ENTRY_LOG};eval.num_votes:0", "--exp_dir", str(exp_plain)],
              plain)
    med_plain = print_probe("train-entry (the iterator in the loop's thread, no eval request)",
                            plain)
    print(f"step median with prefetch {med * 1e3:.3f} ms, without {med_plain * 1e3:.3f} ms; "
          f"the wait a step (median) {statistics.median(probe.waits) * 1e3:.3f} against "
          f"{statistics.median(plain.waits) * 1e3:.3f} ms", flush=True)

    m, built, secs, _ = run_entry(
        ["-c", "s3dis_pt_cbl", "--mode", "val", "--model_path", "auto", "--extra_ops", "",
         "--set", f"{data};{ENTRY_SETS}", "--exp_dir", str(exp)])
    (restored, _, _, r_opt, *_), = built
    live, back = model.state_dict(), restored.state_dict()
    require(live.keys() == back.keys() and all(torch.equal(live[k], back[k]) for k in live),
            "the restored parameters or buffers differ from the saved ones")
    o_live, o_back = opt.state_dict()["state"], r_opt.state_dict()["state"]
    require(o_live.keys() == o_back.keys() and all(
        torch.equal(o_live[i]["momentum_buffer"], o_back[i]["momentum_buffer"]) for i in o_live),
        "the restored optimizer state differs from the saved one")
    p_live = make_eval_step(model, PyramidSpec(), device=dev)(batch)[0]
    p_back = make_eval_step(restored, PyramidSpec(), device=dev)(batch)[0]
    d = float((p_live - p_back).abs().max())
    print(f"--mode val: {secs:.3f} s, restored {len(back)} tensors and {len(o_back)} momentum "
          f"buffers bit for bit; full mIoU {m['full']['mIoU']:.4f} OA {m['full']['OA']:.4f}; "
          f"probs of the restored vs the live model on one batch max|d| {d:.3g}", flush=True)
    require(d <= 1e-6, "the restored model's probs differ from the live model's")


def train_entry_bf16(root: Path) -> None:
    """Phase 25: two steps of s3dis_pt_cbl_bf16 through main.py, no eval
    request: losses finite, the gathers' launches by dtype phase
    bf16-train's."""
    data = f"data.data_root:{root / 'data'}"
    probe = StepProbe()
    _, _, secs, total = run_entry(
        ["-c", "s3dis_pt_cbl_bf16", "--mode", "train", "--set",
         f"{data};{ENTRY_SETS};{ENTRY_LOG};data.loop:1;eval.num_votes:0", "--exp_dir",
         str(root / "exp_bf16")], probe)
    print_probe("train-entry-bf16", probe)
    steps, losses = entry_losses(root / "exp_bf16")
    print(f"{secs:.3f} s; losses {losses} at steps {steps}; launches by dtype a step "
          f"{probe.by_dtype}", flush=True)
    require(len(steps) == 2 and all(np.isfinite(losses)), f"losses {losses}")
    require(all(total[k] > 0 for k in TRAIN_KERNELS), f"a kernel was not launched: {total}")
    for by_dtype in probe.by_dtype:
        require_bf16_counts(by_dtype, BF16_STEP_GATHERS, "a bfloat16 step of main.py")


class RequestProbe:
    """Phase 26's instrumentation of main.py's test mode: ``make_eval_step``
    replaces main.py's and wraps the step it builds: each request ended by a
    synchronize, its seconds and the launches it made; on the first request
    also the probs of the plain versions on the same weights and batch;
    whether each request's probs are finite."""

    def __init__(self):
        self.launches, self.seconds, self.probs, self.finite = [], [], None, []

    def make_eval_step(self, *args, **kw):
        step = entry_eval_step(*args, **kw)

        def probe(batch):
            counts = read_counts()
            t0 = time.perf_counter()
            out = step(batch)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            self.launches.append(count_delta(read_counts(), counts))
            self.finite.append(bool(torch.isfinite(out[0]).all()))
            if self.probs is None:
                with plain_kernels():
                    self.probs = (out[0].clone(), step(batch)[0])
            return out
        return probe


def prepare_test(root: Path, serve_launches: dict, train_launches: dict) -> None:
    """Phase 26: ScanNet's offline path through main.py: raw scenes written,
    prepared, calibrated, trained on and served."""
    raw, data, exp = root / "scannet_raw", root / "scannet", root / "exp_scannet"
    t0 = time.perf_counter()
    for i in range(SCANNET_SCENES):
        write_scannet_scene(str(raw), f"scene{i:04d}_00", np.random.default_rng(i))
    t1 = time.perf_counter()
    converted = prepare_scannet(str(raw), str(data), verbose=False)
    points = {Path(f).stem: len(np.load(f, mmap_mode="r")) for f in converted}
    print(f"wrote {SCANNET_SCENES} raw scenes in {t1 - t0:.3f} s; prepare_scannet "
          f"{time.perf_counter() - t1:.3f} s: points a scene {points}", flush=True)
    require(len(points) == SCANNET_SCENES, f"prepared {sorted(points)}")
    sets = f"data.data_root:{data};{SCANNET_SETS}"

    n_points, _, secs, _ = run_entry(["-c", "scannet_pt_cbl", "--mode", "calibrate", "--set",
                                      sets, "--exp_dir", str(exp)])
    print(f"--mode calibrate: {secs:.3f} s, data.n_points={n_points} (the preset's 65536)",
          flush=True)

    probe = StepProbe()
    _, _, secs, total = run_entry(
        ["-c", "scannet_pt_cbl", "--mode", "train", "--set",
         f"{sets};eval.num_votes:0;{ENTRY_LOG}", "--exp_dir", str(exp)], probe)
    require(all(total[k] > 0 for k in TRAIN_KERNELS), f"a kernel was not launched: {total}")
    print_probe("prepare-test train (scannet_pt_cbl, 20 classes)", probe)
    steps, losses = entry_losses(exp)
    print(f"--mode train: {secs:.3f} s; losses {losses} at steps {steps}", flush=True)
    require(len(steps) == len(probe.steps) > 0 and all(np.isfinite(losses)), f"losses {losses}")
    for i, launches in enumerate(probe.launches):
        got = {k: launches[k] for k in TRAIN_KERNELS}
        require(got == train_launches, f"step {i}: launches {got}, phase train's {train_launches}")

    req = RequestProbe()
    with mock.patch.object(entry, "make_eval_step", req.make_eval_step):
        out, _, secs, _ = run_entry(
            ["-c", "scannet_pt_cbl", "--mode", "test", "--model_path", "auto", "--set", sets,
             "--exp_dir", str(exp), "--out_dir", str(root / "scannet_pred")])
    per = [{k: launches[k] for k in serve_launches} for launches in req.launches]
    probs, plain = req.probs
    print(f"--mode test (the preset's votes): {secs:.3f} s, {len(req.seconds)} requests of "
          f"{tuple(probs.shape)}, request median {statistics.median(req.seconds) * 1e3:.3f} ms, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B; launches a request "
          f"{per[0]}", flush=True)
    require(all(p == serve_launches for p in per),
            f"launches a request {per}, phase serve's {serve_launches}")
    d = float((probs - plain).abs().max())
    agree = float((probs.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"first request, kernels vs plain versions: max|dprobs| {d:.3g}, argmax agreement "
          f"{agree:.6f}", flush=True)
    require(d <= 1e-3 and agree >= 0.999, "test-request probs disagree with the plain versions")
    for name, n in points.items():
        pred = np.load(Path(out) / f"{name}_pred.npy")
        print(f"{name}_pred.npy: {len(pred)} predictions for {n} prepared points, classes "
              f"{np.bincount(pred, minlength=SCANNET_CLASSES).tolist()}", flush=True)
        require(pred.shape == (n,) and np.issubdtype(pred.dtype, np.integer)
                and pred.min() >= 0 and pred.max() < SCANNET_CLASSES, f"{name}: predictions")


def require_launches(what: str, expect: dict) -> dict:
    """The launches read since the last reset are exactly ``expect`` (every
    other kernel 0), and no search went to the wide plain search → the
    counts of ``expect``'s kernels."""
    counts = read_counts()
    got = {k: v for k, v in counts.items() if v}
    require(got == expect and knn.wide_calls == 0,
            f"{what}: launches {got}, not {expect}; wide-window searches {knn.wide_calls}")
    return {k: counts[k] for k in expect}


def prefixed(summary: list, prefix: str) -> list:
    """Kernel entries of a path, named "<prefix>/<kernel>" in the JSON line."""
    for entry_ in summary:
        entry_["name"] = f"{prefix}/{entry_['name']}"
    return summary


def conv_setup(name: str, dev, seed: int = 0):
    """A ConvNet preset's model (fresh weights from ``seed``), its
    optimizer (the preset's) and train step on ``dev``."""
    cfg = load_config(name)
    model = cfg.build_model(device=dev, generator=torch.Generator().manual_seed(seed))
    opt, step = preset_step(cfg, model, dev)
    return cfg, model, opt, step


def preset_step(cfg, model, dev):
    """The preset's optimizer over ``model`` and its train step on ``dev``,
    configured as main.py's setup configures it (the plain mlp head's loss,
    weight and dropout; no class weights)."""
    o = cfg.optim
    opt = make_optimizer(model.parameters(), o.base_lr, momentum=o.momentum,
                         weight_decay=o.weight_decay, grad_clip_norm=o.grad_clip_norm)
    mlp = cfg.heads.get("mlp", {})
    step_cfg = TrainStepConfig(num_classes=cfg.data.num_classes, spec=cfg.pyramid_spec(),
                               contrast=cfg.contrast, ignore_label=cfg.data.ignore_label,
                               main_loss=mlp.get("loss", "xen"),
                               main_weight=mlp.get("weight", 1.0),
                               has_dropout=bool(mlp.get("drop")))
    return opt, make_train_step(model, step_cfg, opt, device=dev)


def grid_crop(n: int, seed: int = 3) -> dict:
    """One synthetic train crop of n points with coordinates on the 1/64 m
    grid: every squared distance exact in float32 on both devices."""
    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    batch = train_batch(rooms, 1, n, np.random.default_rng(seed))
    batch["points"] = (np.round(batch["points"] * 64) / 64).astype(np.float32)
    return batch


def compare_pyramids(spec, points: np.ndarray, dev) -> None:
    """The natural pyramid on the card against the CPU's: every index
    tensor equal (the tile contrast search's Morton orders too) and the
    tile geometry the same, the IDW weights and the relative positions
    within 1e-6."""
    cpu = build_pyramid(torch.as_tensor(points), spec)
    t0 = time.perf_counter()
    card = build_pyramid(torch.as_tensor(points, device=dev), spec)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    n = 0
    require(card.contrast_local == cpu.contrast_local, f"contrast_local {card.contrast_local}")
    for field in ("sample_idx", "self_idx", "down_idx", "up_idx", "near0_idx", "contrast_idx",
                  "subscene_idx", "contrast_order"):
        for level, (a, b) in enumerate(zip(getattr(cpu, field), getattr(card, field))):
            if a is None:
                require(b is None, f"{field}[{level}]")
                continue
            require(torch.equal(a, b.cpu()), f"pyramid {field}[{level}]: card != CPU "
                    f"({int((a != b.cpu()).sum())} of {a.numel()})")
            n += a.numel()
    w = max(float((a - b.cpu()).abs().max()) for a, b in zip(cpu.up_w[1:], card.up_w[1:]))
    rel = max(float((a - b.cpu()).abs().max())
              for f in ("self_rel", "down_rel") for a, b in zip(getattr(cpu, f), getattr(card, f))
              if a is not None)
    print(f"natural pyramid of {points.shape[1]} grid points: card = CPU on {n} indices, "
          f"max|d up_w| {w:.3g}, max|d self_rel, down_rel| {rel:.3g} (card {secs * 1e3:.3f} ms)",
          flush=True)
    require(w <= 1e-6 and rel <= 1e-6, "up_w or the relative positions")


def card_vs_cpu_step(model, step, cpu_step_of, crop) -> None:
    """One train step on the grid crop on the card and, from the same
    weights, on a CPU copy of the model (``cpu_step_of(copy)`` its step):
    loss rel <= 1e-4, gradient norm rel <= 1e-3."""
    cpu_model = copy.deepcopy(model).cpu()
    cpu_step = cpu_step_of(cpu_model)
    m_card = step(crop)
    loss_c, gn_c = float(m_card["loss"]), grad_norm(model)
    m_cpu = cpu_step(crop)
    loss_p, gn_p = float(m_cpu["loss"]), grad_norm(cpu_model)
    print(f"one step on the grid crop, card vs CPU from the same weights: loss {loss_c:.7f} vs "
          f"{loss_p:.7f} (rel {abs(loss_c - loss_p) / abs(loss_p):.3g}), gradient norm "
          f"{gn_c:.7f} vs {gn_p:.7f} (rel {abs(gn_c - gn_p) / gn_p:.3g}); stages "
          + ", ".join(f"{k} {float(m_card[k]):.6f}/{float(m_cpu[k]):.6f}" for k in m_card
                      if k.startswith("cbl_stage")), flush=True)
    require(abs(loss_c - loss_p) <= 1e-4 * abs(loss_p), "card and CPU losses disagree")
    require(abs(gn_c - gn_p) <= 1e-3 * gn_p, "card and CPU gradient norms disagree")


def fitting_batch(model, opt, step, snap0, b: int) -> tuple:
    """A warm-up step on b synthetic train crops of N points, b halved while
    the step does not fit in the card's memory → (the batch, b)."""
    while True:
        batch = preset_batch(b)
        try:
            torch.cuda.reset_peak_memory_stats()
            step(batch)  # warm-up: library handles, allocator
            torch.cuda.synchronize()
            return batch, b
        except torch.cuda.OutOfMemoryError:
            del batch
            restore(model, opt, snap0)
            torch.cuda.empty_cache()
            print(f"batch {b} x {N} does not fit in the card's memory; halved", flush=True)
            require(b > 1, "one crop does not fit")
            b //= 2


def conv_train(dev) -> dict:
    """Phase 27."""
    cfg, model, opt, step = conv_setup(CONV_PRESETS[0], dev)
    spec = cfg.pyramid_spec()
    nparams = sum(p.numel() for p in model.parameters())
    print(f"{CONV_PRESETS[0]}: {nparams} parameters, spec {spec}", flush=True)
    reset_counts()

    crop = grid_crop(CONV_GRID_N)
    compare_pyramids(spec, crop["points"], dev)
    snap0 = snapshot(model, opt)
    card_vs_cpu_step(model, step, lambda cpu: preset_step(cfg, cpu, "cpu")[1], crop)
    restore(model, opt, snap0)

    batch, b = fitting_batch(model, opt, step, snap0, CONV_B)
    print(f"batch {b} x {N} (the preset's {cfg.optim.batch_size})", flush=True)
    restore(model, opt, snap0)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        print("  step: " + ", ".join(f"{k} {float(v):.6f}" for k, v in m.items()
                                      if k != "confusion"), flush=True)
    med = statistics.median(secs[2:])
    peak = torch.cuda.max_memory_allocated()
    print(f"ConvNet train step ({CONV_PRESETS[0]}, B={b}) median of 3 warm steps "
          f"{med * 1e3:.3f} ms over {[round(x * 1e3, 3) for x in secs]}, {b * N / med:.1f} "
          f"points/s, max_memory_allocated {peak} B", flush=True)
    require(all(np.isfinite(losses)), f"losses {losses}")
    require(losses[-1] < losses[0], f"5 steps on one batch did not lower the loss: {losses}")
    busy_ms = profile_request(step, batch, top=20, what="ConvNet train step")
    print(f"device busy {busy_ms:.3f} ms of the unprofiled median step {med * 1e3:.3f} ms: "
          f"busy share {busy_ms / (med * 1e3):.3f}", flush=True)
    pts_dev = torch.as_tensor(batch["points"], device=dev)
    pyr_ms = time_ms(lambda: build_pyramid(pts_dev, spec), reps=1)
    print(f"device time of the training pyramid alone {pyr_ms:.3f} ms", flush=True)
    require_launches("the ConvNet train steps", {})
    del opt, step
    torch.cuda.empty_cache()

    for name in CONV_PRESETS[1:]:
        _, other, other_opt, other_step = conv_setup(name, dev)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = other_step(batch)
        torch.cuda.synchronize()
        loss = float(m["loss"])
        print(f"{name}: one step at B={b}: {(time.perf_counter() - t0) * 1e3:.3f} ms (cold), "
              + ", ".join(f"{k} {float(v):.6f}" for k, v in m.items() if k != "confusion")
              + f", max_memory_allocated {torch.cuda.max_memory_allocated()} B", flush=True)
        require(np.isfinite(loss) and all(np.isfinite(float(v)) for k, v in m.items()
                                          if k != "confusion"), f"{name}: loss {loss}")
        require_launches(name, {})
        del other, other_opt, other_step, m
        torch.cuda.empty_cache()
    return dict(model=model, cfg=cfg, batch=batch, crop=crop, med=med, peak=peak, b=b,
                pyr_ms=pyr_ms)


def conv_serve(dev, trained: dict) -> None:
    """Phase 28."""
    model, cfg, batch, crop = (trained[k] for k in ("model", "cfg", "batch", "crop"))
    spec = cfg.pyramid_spec()
    step = make_eval_step(model, spec, dev, num_classes=cfg.data.num_classes)
    reset_counts()
    probs, _ = step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        probs, conf = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(probs).all()), "ConvNet request probs not finite")
    labels = torch.as_tensor(batch["labels"], device=dev)
    oa = float((probs.argmax(-1) == labels).float().mean())
    print(f"ConvNet request (B={probs.shape[0]} x {probs.shape[1]}): median of 3 "
          f"{statistics.median(secs) * 1e3:.3f} ms over {[round(x * 1e3, 3) for x in secs]}, "
          f"max_memory_allocated {peak} B, crop OA {oa:.4f} after 5 steps", flush=True)
    busy = profile_request(step, batch, top=12, what="ConvNet request")
    print(f"device busy {busy:.3f} ms of the median request: busy share "
          f"{busy / (statistics.median(secs) * 1e3):.3f}", flush=True)
    card, _ = step(crop)
    cpu_probs, _ = make_eval_step(copy.deepcopy(model).cpu(), spec, "cpu",
                                  num_classes=cfg.data.num_classes)(crop)
    d = float((card.cpu() - cpu_probs).abs().max())
    agree = float((card.cpu().argmax(-1) == cpu_probs.argmax(-1)).float().mean())
    print(f"grid crop of {CONV_GRID_N} points, card vs CPU probs: max|d| {d:.3g}, argmax "
          f"agreement {agree:.6f}", flush=True)
    require(d <= 1e-4 and agree >= 0.999, "card and CPU probs disagree")
    require_launches("the ConvNet requests", {})


def conv_entry(root: Path) -> None:
    """Phase 29: scannet_conv_cbl through main.py on phase 26's scenes."""
    data, exp = root / "scannet", root / "exp_scannet_conv"
    sets = f"data.data_root:{data};{SCANNET_CUTS}"
    print(f"main.py -c {CONV_ENTRY} --set {sets}: full width, the natural layout; cuts: batch "
          f"8 -> 2, epochs 600 -> 1, loop 30 -> 2", flush=True)
    _, _, secs, total = run_entry(["-c", CONV_ENTRY, "--mode", "calibrate", "--set", sets,
                                   "--exp_dir", str(exp)])
    log = (exp / "log_calibrate.txt").read_text()
    caps = re.search(r"model\.neighborhood_limits=\(([\d, ]+)\)", log)
    require(caps is not None, "no neighbour caps in the calibrate log")
    caps = [int(c) for c in caps.group(1).split(",")]
    print(f"--mode calibrate: {secs:.3f} s, neighbour caps {caps} (the preset's "
          f"{list(load_config(CONV_ENTRY).model.neighborhood_limits)})", flush=True)
    require(not any(total.values()), f"calibrate launched {total}")
    sets = f"{sets};model.neighborhood_limits:{json.dumps(caps)}"

    probe = StepProbe()
    _, built, secs, total = run_entry(
        ["-c", CONV_ENTRY, "--mode", "train", "--set", f"{sets};eval.num_votes:0;{ENTRY_LOG}",
         "--exp_dir", str(exp)], probe)
    require(tuple(built[0][1].k_self) == tuple(caps), f"caps not taken: {built[0][1]}")
    print_probe(f"conv-entry train ({CONV_ENTRY}, 20 classes)", probe)
    steps, losses = entry_losses(exp)
    print(f"--mode train: {secs:.3f} s; losses {losses} at steps {steps}", flush=True)
    require(len(steps) == len(probe.steps) > 0 and all(np.isfinite(losses)), f"losses {losses}")
    require(not any(total.values()), f"train launched {total}")

    req = RequestProbe()
    with mock.patch.object(entry, "make_eval_step", req.make_eval_step):
        out, _, secs, total = run_entry(
            ["-c", CONV_ENTRY, "--mode", "test", "--model_path", "auto", "--set", sets,
             "--exp_dir", str(exp), "--out_dir", str(root / "scannet_conv_pred")])
    print(f"--mode test (the preset's votes): {secs:.3f} s, {len(req.seconds)} requests, request "
          f"median {statistics.median(req.seconds) * 1e3:.3f} ms, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    require(all(req.finite), "a request's probs are not finite")
    require(not any(total.values()), f"test launched {total}")
    for f in sorted(Path(out).glob("*_pred.npy")):
        pred = np.load(f)
        n = len(np.load(data / f.name.replace("_pred.npy", ".npy"), mmap_mode="r"))
        require(pred.shape == (n,) and pred.min() >= 0 and pred.max() < SCANNET_CLASSES,
                f"{f.name}: predictions")
    print(f"{len(list(Path(out).glob('*_pred.npy')))} scenes predicted", flush=True)


def pt_natural_model(cfg, dev):
    """The preset's point transformer from the checkpoint (the same
    parameter tree as the sorted flagship's), or fresh weights from seed 0
    where it is absent."""
    model = cfg.build_model(device=dev, generator=torch.Generator().manual_seed(0))
    if CKPT.exists():
        load_jax_variables(model, load_checkpoint(str(CKPT)))
    return model


def pt_natural_step(cfg, model, dev):
    opt = make_optimizer(model.parameters(), TRAIN_LR)
    step_cfg = TrainStepConfig(num_classes=cfg.data.num_classes, spec=cfg.pyramid_spec(),
                               contrast=cfg.contrast, ignore_label=cfg.data.ignore_label)
    return opt, make_train_step(model, step_cfg, opt, device=dev)


@torch.no_grad()
def check_fps(dev, step_calls, launches, grid_calls, points) -> dict:
    """The FPS kernel against its plain version: every call of the grid
    crop's pyramid and of the step's (``launches`` the step's count), and
    one exact FPS of a cloud of N points to N / 4; the step's calls and the
    exact one timed."""
    for c in grid_calls:
        compare_call("fps", c)
    print(f"  grid crop: {len(grid_calls)} fps calls equal to the plain version", flush=True)
    fps_entry, = time_calls({"fps": step_calls}, dev, {"fps": launches}, {"fps": 0.0},
                            ("fps",), reps=5)
    pts = torch.as_tensor(points[:1], device=dev)
    out = sampling.fps(pts, N // 4)
    # one timed run of each after a warm one: the plain chain takes ~3.4 s
    exact, = time_calls({"fps": [((pts.contiguous(), N // 4), {}, out)]}, dev, {"fps": 1},
                        {"fps": 0.0}, ("fps",), reps=1)
    steps = N // 4 - 1
    print(f"  exact fps {N} -> {N // 4} on one cloud: equal to the plain version; kernel "
          f"{exact['ms']:.3f} ms ({exact['ms'] / steps * 1e3:.3f} us a chain step), plain "
          f"{exact['plain_ms']:.3f} ms, bound {exact['bound_ms']:.5f} ms ({exact['bound_by']})",
          flush=True)
    fps_entry["exact"] = {k: exact[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    fps_entry["exact"]["shape"] = dict(points=N, picks=N // 4, chain_steps=steps)
    return fps_entry


def pt_natural_train(dev) -> dict:
    """Phase 30."""
    cfg = load_config(PT_NATURAL)
    spec = cfg.pyramid_spec()
    levels = spec.num_levels - 1  # one fps launch a sampled level
    model = pt_natural_model(cfg, dev)
    opt, step = pt_natural_step(cfg, model, dev)
    print(f"{PT_NATURAL}: planes {cfg.model.planes}, blocks {cfg.model.blocks}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, "
          f"{'the checkpoint' if CKPT.exists() else 'fresh weights (seed 0)'}; spec {spec}; "
          f"cut: batch {cfg.optim.batch_size} -> {B}; SGD lr {TRAIN_LR}", flush=True)
    snap0 = snapshot(model, opt)

    crop = grid_crop(CONV_GRID_N)
    with recording() as grid_calls:
        compare_pyramids(spec, crop["points"], dev)
    grid_fps = [c for c in grid_calls["fps"] if c[0][0].is_cuda]
    card_vs_cpu_step(model, step, lambda cpu: pt_natural_step(cfg, cpu, "cpu")[1], crop)
    restore(model, opt, snap0)

    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    batch = train_batch(rooms, B, N, np.random.default_rng(0))
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with recording() as calls:
        step(batch)
        torch.cuda.synchronize()
    counts = require_launches("a batch-BN train step", {"fps": levels})
    print(f"launches in one batch-BN train step: fps {counts['fps']} (the {levels} sampled "
          f"levels), every other kernel 0", flush=True)
    restore(model, opt, snap0)
    losses, secs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        print("  step: " + ", ".join(f"{k} {float(v):.6f}" for k, v in m.items()
                                      if k != "confusion"), flush=True)
    med = statistics.median(secs[2:])
    peak = torch.cuda.max_memory_allocated()
    print(f"natural train step ({PT_NATURAL}, B={B}) median of 3 warm steps {med * 1e3:.3f} ms "
          f"over {[round(x * 1e3, 3) for x in secs]}, {B * N / med:.1f} points/s, "
          f"max_memory_allocated {peak} B", flush=True)
    require(all(np.isfinite(losses)), f"losses {losses}")
    require(losses[-1] < losses[0], f"5 steps on one batch did not lower the loss: {losses}")
    busy_ms = profile_request(step, batch, top=15, what="natural train step")
    print(f"device busy {busy_ms:.3f} ms of the unprofiled median step {med * 1e3:.3f} ms: "
          f"busy share {busy_ms / (med * 1e3):.3f}", flush=True)
    pts_dev = torch.as_tensor(batch["points"], device=dev)
    pyr_ms = time_ms(lambda: build_pyramid(pts_dev, spec), reps=1)
    print(f"device time of the training pyramid alone {pyr_ms:.3f} ms", flush=True)

    stale_cfg = load_config(PT_NATURAL, "model.bn_mode:stale")
    stale = stale_cfg.build_model(device=dev)
    stale.load_state_dict(model.state_dict())
    _, stale_step = pt_natural_step(stale_cfg, stale, dev)
    reset_counts()
    t0 = time.perf_counter()
    ms = stale_step(batch)
    torch.cuda.synchronize()
    require_launches("a stale-BN train step", {"fps": levels})
    print(f"one stale-BN step (the unfused attention, StaleBatchNorm): "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms (cold), loss {float(ms['loss']):.6f}; "
          f"launches: fps {levels}, every other kernel 0", flush=True)
    require(np.isfinite(float(ms["loss"])), "stale loss not finite")
    del stale, stale_step, ms

    summary = check_fps(dev, calls["fps"], counts["fps"], grid_fps, batch["points"])
    del calls, grid_calls, opt, step
    torch.cuda.empty_cache()
    return dict(model=model, cfg=cfg, spec=spec, crop=crop, levels=levels, summary=summary,
                batch=batch, med=med, peak=peak, pyr_ms=pyr_ms)


def pt_natural_serve(dev, trained: dict) -> float:
    """Phase 31 → the median request's seconds."""
    model, cfg, spec, crop = (trained[k] for k in ("model", "cfg", "spec", "crop"))
    b = cfg.eval.batch_size
    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    batch = train_batch(rooms, b, N, np.random.default_rng(1))
    step = make_eval_step(model, spec, dev, num_classes=cfg.data.num_classes)
    reset_counts()
    probs, _ = step(batch)
    torch.cuda.synchronize()
    require_launches("a request", {"fps": trained["levels"]})
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        probs, _ = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med, peak = statistics.median(secs), torch.cuda.max_memory_allocated()
    require(bool(torch.isfinite(probs).all()), "natural request probs not finite")
    labels = torch.as_tensor(batch["labels"], device=dev)
    oa = float((probs.argmax(-1) == labels).float().mean())
    print(f"natural request (B={b}, the preset's eval batch, x {N}): median of 3 "
          f"{med * 1e3:.3f} ms over {[round(x * 1e3, 3) for x in secs]}, {b * N / med:.1f} "
          f"points/s, max_memory_allocated {peak} B, crop OA {oa:.4f}; launches: fps "
          f"{trained['levels']}, every other kernel 0", flush=True)
    busy = profile_request(step, batch, top=12, what="natural request")
    print(f"device busy {busy:.3f} ms of the median request: busy share "
          f"{busy / (med * 1e3):.3f}", flush=True)
    card, _ = step(crop)
    cpu_probs, _ = make_eval_step(copy.deepcopy(model).cpu(), spec, "cpu",
                                  num_classes=cfg.data.num_classes)(crop)
    d = float((card.cpu() - cpu_probs).abs().max())
    agree = float((card.cpu().argmax(-1) == cpu_probs.argmax(-1)).float().mean())
    print(f"grid crop of {CONV_GRID_N} points, card vs CPU probs: max|d| {d:.3g}, argmax "
          f"agreement {agree:.6f}", flush=True)
    require(d <= 1e-4 and agree >= 0.999, "card and CPU probs disagree")
    return med


def natural_entry_train(argv, what, levels, expect=None) -> StepProbe:
    """One --mode train run of a natural point-transformer preset through
    main.py: the natural spec built, every step's loss finite, each step's
    launches ``expect`` (default: the sampled levels' fps) and nothing
    else."""
    probe = StepProbe()
    _, built, secs, total = run_entry(argv, probe)
    (_, spec, *_), = built
    require((spec.layout, spec.sampler) == ("natural", "bucket_fps"), f"spec {spec}")
    print_probe(what, probe)
    exp = Path(argv[argv.index("--exp_dir") + 1])
    steps, losses = entry_losses(exp)
    print(f"--mode train: {secs:.3f} s; losses {losses} at steps {steps}; launches of the run "
          f"{ {k: v for k, v in total.items() if v} }", flush=True)
    require(len(steps) == len(probe.steps) > 0 and all(np.isfinite(losses)), f"losses {losses}")
    expect = expect or {"fps": levels}
    for i, launches in enumerate(probe.launches):
        got = {k: v for k, v in launches.items() if v}
        require(got == expect, f"step {i}: launches {got}, not {expect}")
    require(not {k: v for k, v in total.items() if k not in expect and v}, f"launches {total}")
    return probe


def pt_natural_entry(root: Path, levels: int) -> None:
    """Phase 32: s3dis_pt_cbl_paper through main.py on phase 24's rooms
    (train, then val), and scannet_pt_cbl as published on phase 26's
    scenes."""
    exp = root / "exp_pt_natural"
    sets = f"data.data_root:{root / 'data'};{ENTRY_SETS}"
    print(f"main.py -c {PT_NATURAL} --set {sets}: full width, the natural layout, bucket_fps; "
          f"cuts: batch 16 -> 2, epochs 200 -> 1, loop 30 -> 2, num_votes 20 -> 1", flush=True)
    natural_entry_train(["-c", PT_NATURAL, "--mode", "train", "--set", f"{sets};{ENTRY_LOG}",
                         "--exp_dir", str(exp)], f"pt-natural-entry train ({PT_NATURAL})",
                        levels)
    m, _, secs, total = run_entry(["-c", PT_NATURAL, "--mode", "val", "--model_path", "auto",
                                   "--extra_ops", "", "--set", sets, "--exp_dir", str(exp)])
    print(f"--mode val: {secs:.3f} s, full mIoU {m['full']['mIoU']:.4f} OA {m['full']['OA']:.4f}; "
          f"launches {total}", flush=True)
    require(np.isfinite(m["full"]["OA"]) and total["fps"] > 0
            and not {k: v for k, v in total.items() if k != "fps" and v}, f"launches {total}")
    sets = f"data.data_root:{root / 'scannet'};{SCANNET_CUTS};eval.num_votes:0;{ENTRY_LOG}"
    print(f"main.py -c {PT_NATURAL_SCANNET} --set {sets}: as published (the natural layout), "
          f"phase 26's cuts", flush=True)
    natural_entry_train(["-c", PT_NATURAL_SCANNET, "--mode", "train", "--set", sets,
                         "--exp_dir", str(root / "exp_scannet_natural")],
                        f"pt-natural-entry train ({PT_NATURAL_SCANNET}, 20 classes)", levels)


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_ranks(world: int, cmd: list, logs: Path, what: str, timeout: float = 600) -> list:
    """``cmd`` as ``world`` processes, rank r under CBL_COORDINATOR (a free
    localhost port), CBL_NUM_PROCESSES = world and CBL_PROCESS_ID = r, all
    started together → each rank's output; raises unless every rank exits
    0 within ``timeout`` seconds (the others are killed then)."""
    logs.mkdir(parents=True, exist_ok=True)
    coord = f"localhost:{free_port()}"
    procs = []
    for r in range(world):
        env = {**os.environ, "CBL_COORDINATOR": coord, "CBL_NUM_PROCESSES": str(world),
               "CBL_PROCESS_ID": str(r)}
        with open(logs / f"{what}_rank{r}.log", "w") as f:
            procs.append(subprocess.Popen(cmd, env=env, stdout=f, stderr=subprocess.STDOUT,
                                          cwd=ROOT))
    t_end = time.perf_counter() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(t_end - time.perf_counter(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [(logs / f"{what}_rank{r}.log").read_text() for r in range(world)]
    for r, (p, out) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"{what}: rank {r} of {world} exited {p.returncode}:\n"
                                   f"{out[-6000:]}")
    return outs


def dp_rank(out: Path, backend: str, device: str) -> int:
    """One rank of phase dp-gloo (or of dp-nccl's comparison): the flagship
    train steps of DP_SEEDS on this rank's rows of the global batches in
    ``out``, the model and its optimizer from the checkpoint, each step's
    metrics, kernel launches, collectives, time and state saved to ``out``
    (rank 0 also saves the state before each step)."""
    info = parallel.maybe_initialize_distributed(device, backend=backend)
    dev, rank, world = info["device"], info["process_index"], info["process_count"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.type == "cuda":
        build.library()
    cfg = TrainStepConfig(num_classes=NUM_CLASSES, spec=TRAIN_SPEC, contrast=ContrastConfig())
    for mode, seeds in DP_SEEDS.items():
        model = parallel.replicate(load_model(mode)[0].to(dev))
        opt = make_optimizer(model.parameters(), TRAIN_LR)
        step = make_train_step(model, cfg, opt, device=dev)
        for i, seed in enumerate(seeds):
            batch = parallel.local_rows(dict(np.load(out / f"batch{seed}.npz")))
            if rank == 0:
                torch.save(snapshot(model, opt), out / f"{mode}{i}_before.pt")
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            reset_counts()
            parallel.reset_counts()
            t0 = time.perf_counter()
            m = step(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            launches, coll = read_counts(), parallel.read_counts()
            print(f"dp rank {rank} of {world} ({backend}, {dev}), {mode} BN step {i}: "
                  f"{secs * 1e3:.3f} ms, loss {float(m['loss']):.7f}, launches "
                  f"{ {k: v for k, v in launches.items() if v} }, collectives {coll}", flush=True)
            torch.save({"metrics": {k: v.cpu() for k, v in m.items()}, "launches": launches,
                        "collectives": coll, "secs": secs, "points": len(batch["points"]),
                        "after": {k: v.cpu() for k, v in model.state_dict().items()}},
                       out / f"{mode}{i}_rank{rank}.pt")
        del model, opt, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return 0


def dp_compare(dev, out: Path, world: int, backend: str, rank_device: str) -> None:
    """Phase 33 (two gloo ranks on the one card) and phase 34's comparison
    on 2-4 cards (NCCL, one card a rank): ``world`` ranks each take one
    cloud of B = world crops of N points, for two batch-BN steps (the
    dense CBL route) and one stale-BN step from the checkpoint; then from
    rank 0's state before each step the world-size-1 kernel step on all
    the clouds, in this process. Held: loss and metrics rtol 2e-4, the
    confusion's rows exact and at most 0.1% of points elsewhere, the
    parameters within 1e-2 of the update, the running statistics
    elementwise to rtol 1e-5 plus 1e-5 of each statistic's RMS (the CPU
    tests' tolerances,
    tests/test_torch_parallel.py), every rank's state bit for bit rank
    0's, every rank's kernel launches those of the world-size-1 step, its
    collectives all-reduces only."""
    out.mkdir(parents=True, exist_ok=True)
    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    for seed in sorted({s for seeds in DP_SEEDS.values() for s in seeds}):
        np.savez(out / f"batch{seed}.npz",
                 **train_batch(rooms, world, N, np.random.default_rng(seed)))
    print(f"{world} ranks ({backend}, {rank_device}): one crop of {N} points each; card: "
          f"{card_line() if dev.type == 'cuda' else 'none'}", flush=True)
    t0 = time.perf_counter()
    run_ranks(world, [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-rank", str(out),
                      backend, rank_device], out, f"dp_{backend}")
    print(f"ranks done in {time.perf_counter() - t0:.3f} s", flush=True)
    cfg = TrainStepConfig(num_classes=NUM_CLASSES, spec=TRAIN_SPEC, contrast=ContrastConfig())
    for mode, seeds in DP_SEEDS.items():
        model, _ = load_model(mode)
        opt = make_optimizer(model.parameters(), TRAIN_LR)
        step = make_train_step(model, cfg, opt, device=dev)
        for i, seed in enumerate(seeds):
            what = f"{mode} BN step {i}"
            ranks = [torch.load(out / f"{mode}{i}_rank{r}.pt", map_location="cpu")
                     for r in range(world)]
            restore(model, opt, torch.load(out / f"{mode}{i}_before.pt", map_location=dev))
            before = {k: v.detach().cpu().clone() for k, v in model.named_parameters()}
            batch = dict(np.load(out / f"batch{seed}.npz"))
            reset_counts()
            m = {k: v.cpu() for k, v in step(batch).items()}
            launches = read_counts()
            after = {k: v.detach().cpu() for k, v in model.state_dict().items()}
            got = ranks[0]
            for k in m:
                if k == "confusion":
                    continue
                a, b = float(got["metrics"][k]), float(m[k])
                require(abs(a - b) <= 2e-4 * abs(b), f"{what}: {k} {a} at W={world}, {b} at W=1")
            ca, cb = got["metrics"]["confusion"], m["confusion"]
            moved = float((ca - cb).abs().sum())
            require(torch.equal(ca.sum(1), cb.sum(1)) and moved <= 2e-3 * world * N,
                    f"{what}: confusion moved by {moved}")
            keys = sorted(before)
            dist = float(torch.sqrt(sum(((got["after"][k].double() - after[k].double()) ** 2)
                                        .sum() for k in keys)))
            change = float(torch.sqrt(sum(((after[k].double() - before[k].double()) ** 2).sum()
                                          for k in keys)))
            stats = max(float(((got["after"][k] - v).double().abs()
                               / (1e-5 * (v.double().abs() + v.double().square().mean().sqrt()))
                               .clamp_min(1e-30)).max())
                        for k, v in after.items() if k not in before)
            same = all(torch.equal(r["after"][k], got["after"][k]) for r in ranks[1:]
                       for k in after)
            print(f"{what}: loss {float(got['metrics']['loss']):.7f} at W={world} vs "
                  f"{float(m['loss']):.7f} at W=1; parameters {dist:.4g} from W=1's of an update "
                  f"of {change:.4g} ({dist / change:.3g}); running statistics at {stats:.3g} of their "
                  f"bound; "
                  f"confusion moved by {moved:.0f} points; ranks' states bit for bit: {same}",
                  flush=True)
            require(dist <= 1e-2 * change, f"{what}: parameters {dist} from W=1's, update {change}")
            require(stats <= 1, f"{what}: running statistics at {stats} of their bound")
            require(same, f"{what}: the ranks' states differ")
            for r, res in enumerate(ranks):
                coll = res["collectives"]
                print(f"  rank {r}: {res['points']} crop(s), {res['secs'] * 1e3:.3f} ms "
                      f"({backend}; a check, not a figure), launches "
                      f"{ {k: v for k, v in res['launches'].items() if v} }, all-reduce "
                      f"{coll['all_reduce']['calls']} calls {coll['all_reduce']['bytes']} B",
                      flush=True)
                require(res["launches"] == launches,
                        f"{what}: rank {r}'s launches {res['launches']}, W=1's {launches}")
                require(coll["all_reduce"]["calls"] > 0
                        and not any(v["calls"] for k, v in coll.items() if k != "all_reduce"),
                        f"{what}: rank {r}'s collectives {coll}")
            path = TRAIN_KERNELS + (("pt_attn_fwd", "pt_attn_bwd") if mode == "stale" else ())
            require(all(launches[k] > 0 for k in path), f"{what}: launches {launches}")
        del model, opt, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def nccl_rank() -> int:
    """One rank of dp-nccl's check: an NCCL group on cuda:<rank> and one
    all-reduce of rank + 1."""
    world, rank = int(os.environ["CBL_NUM_PROCESSES"]), int(os.environ["CBL_PROCESS_ID"])
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://{os.environ['CBL_COORDINATOR']}", world_size=world,
        rank=rank)
    t = torch.full((1,), rank + 1.0, device=dev)
    torch.distributed.all_reduce(t)
    require(float(t) == world * (world + 1) / 2, f"all-reduce gave {float(t)}")
    print(f"nccl rank {rank} of {world}: all-reduce {float(t)}", flush=True)
    torch.distributed.destroy_process_group()
    return 0


def dp_nccl(dev, root: Path) -> None:
    """Phase 34: an NCCL group over the visible cards (at most 4) and one
    all-reduce; then main.py --mode train of s3dis_pt_cbl on phase 24's
    rooms under the CBL_* variables, one process a card (one epoch, the
    batch a multiple of the world size); at world size 1 its steps issue
    no collective. On 2-4 cards, phase 33's comparison under NCCL."""
    world = min(torch.cuda.device_count(), DP_MAX_WORLD)
    print(f"card: {card_line()}; {world} card(s) visible", flush=True)
    logs = root / "dp_nccl"
    outs = run_ranks(world, [sys.executable, str(ROOT / "chip_smoke.py"), "--nccl-rank"],
                     logs, "nccl")
    print("".join(ln for o in outs for ln in o.splitlines(True) if ln.startswith("nccl rank")),
          end="", flush=True)
    bs = math.lcm(2, world)
    loop = -(-world * bs // ENTRY_ROOMS)
    exp = root / "exp_dp"
    sets = (f"data.data_root:{root / 'data'};optim.batch_size:{bs};eval.batch_size:{bs};"
            f"optim.epochs:1;data.loop:{loop};eval.num_votes:0.1;{ENTRY_LOG}")
    print(f"main.py -c s3dis_pt_cbl --mode train --set {sets} at world size {world}", flush=True)
    t0 = time.perf_counter()
    run_ranks(world, [sys.executable, "-m", "contrastboundary_tpu_torch.main", "-c",
                      "s3dis_pt_cbl", "--mode", "train", "--set", sets, "--exp_dir", str(exp)],
              logs, "main")
    secs = time.perf_counter() - t0
    log = (exp / "log_train.txt").read_text()
    coll = re.search(r"collectives over (\d+) steps: (\{.*\})", log)
    require(coll is not None and f"(rank 0 of {world})" in log, "main.py's log")
    n_steps, counts = int(coll.group(1)), ast.literal_eval(coll.group(2))
    steps, losses = entry_losses(exp)
    print(f"main.py at world size {world}: {secs:.3f} s (processes included), {n_steps} steps "
          f"a rank, losses {losses}, collectives of the epoch's steps {counts}", flush=True)
    require(n_steps > 0 and len(losses) == n_steps and all(np.isfinite(losses)),
            f"losses {losses}")
    require((exp / "checkpoints" / "best.json").exists(), "no snapshot")
    if world == 1:
        require(all(v == {"calls": 0, "bytes": 0} for v in counts.values()),
                f"collectives at world size 1: {counts}")
    else:
        require(counts["all_reduce"]["calls"] > 0, f"collectives {counts}")
        dp_compare(dev, root / "dp_nccl_compare", world, "nccl", "cuda")


def preset_batch(b: int, seed: int = 0) -> dict:
    """b synthetic train crops of N points (the train phases' rooms)."""
    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    return train_batch(rooms, b, N, np.random.default_rng(seed))


def timed_steps(step, batch, n: int, reset=None) -> tuple:
    """n train steps on ``batch``, each ended by a synchronize, and each
    after ``reset()`` (outside the time) where given → (losses,
    seconds)."""
    losses, secs = [], []
    for _ in range(n):
        if reset is not None:
            reset()
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
    return losses, secs


def pt_base_launches(counts: dict, stale: bool) -> dict:
    """The launches of an s3dis_pt step (no CBL): the path's kernels, and
    under stale BN the attention's 18 a direction; no CBL kernel, no kernel
    of no path and no FPS."""
    names = PATH_KERNELS + (("pt_attn_fwd", "pt_attn_bwd") if stale else ())
    launches = {k: counts[k] for k in names}
    others = {k: v for k, v in counts.items() if k not in names and v}
    require(all(v > 0 for v in launches.values()) and not others,
            f"{PT_BASE} launches {launches}, others {others}")
    return launches


def pt_base_train(dev) -> dict:
    """Phase 35."""
    cfg = load_config(PT_BASE)
    spec = cfg.pyramid_spec()
    model = cfg.build_model(device=dev)
    load_jax_variables(model, random_flax_tree(model, 0))
    opt, step = preset_step(cfg, model, dev)
    o = cfg.optim
    print(f"{PT_BASE}: planes {cfg.model.planes}, blocks {cfg.model.blocks}, "
          f"{sum(p.numel() for p in model.parameters())} parameters from random_flax_tree "
          f"(seed 0), the plain head {cfg.heads or 'xen, depth 1'}; spec {spec}; cut: batch "
          f"{o.batch_size} -> {B}; the preset's SGD (lr {o.base_lr}, momentum {o.momentum}, "
          f"decay {o.weight_decay})", flush=True)
    batch = preset_batch(B)
    snap0 = snapshot(model, opt)
    step(batch)  # warm-up: library handles, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # every timed step from the same weights: at the preset's rate 0.5 random
    # weights need not train, and the time is the step's, not the run's
    losses, secs = timed_steps(step, batch, 4, lambda: restore(model, opt, snap0))
    med, peak = statistics.median(secs[1:]), torch.cuda.max_memory_allocated()
    print(f"{PT_BASE} train step (batch BN, B={B}) median of 3 warm steps {med * 1e3:.3f} ms "
          f"over {[round(x * 1e3, 3) for x in secs]}, {B * N / med:.1f} points/s, "
          f"max_memory_allocated {peak} B; losses {losses} (each from the same weights); "
          f"card: {card_line()}", flush=True)
    require(all(np.isfinite(losses)), f"losses {losses}")
    restore(model, opt, snap0)
    reset_counts()
    with recording() as calls:
        m = step(batch)
        torch.cuda.synchronize()
    launches = pt_base_launches(read_counts(), stale=False)
    print(f"launches in one batch-BN train step: {launches}; wide-window searches (plain "
          f"PyTorch): {knn.wide_calls}; CBL kernels 0", flush=True)
    step_against_plain(model, opt, step, batch, snap0, m)

    stale_cfg = load_config(PT_BASE, "model.bn_mode:stale")
    stale = stale_cfg.build_model(device=dev)
    stale.load_state_dict(snap0[0])
    stale_opt, stale_step = preset_step(stale_cfg, stale, dev)
    stale_snap = snapshot(stale, stale_opt)
    stale_step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stale_losses, stale_secs = timed_steps(stale_step, batch, 3,
                                           lambda: restore(stale, stale_opt, stale_snap))
    print(f"{PT_BASE} train step (stale BN) median of 3 {statistics.median(stale_secs) * 1e3:.3f}"
          f" ms over {[round(x * 1e3, 3) for x in stale_secs]}, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; losses {stale_losses}", flush=True)
    require(all(np.isfinite(stale_losses)), f"stale losses {stale_losses}")
    restore(stale, stale_opt, stale_snap)
    reset_counts()
    with recording() as stale_calls:
        ms = stale_step(batch)
        torch.cuda.synchronize()
    stale_launches = pt_base_launches(read_counts(), stale=True)
    print(f"launches in one stale-BN train step: {stale_launches}", flush=True)
    for name in ("pt_attn_fwd", "pt_attn_bwd"):
        require(stale_launches[name] == ATTENTION_LAYERS, f"{name}: {stale_launches[name]}")
    for name in ("window_gather", "window_gather_bwd"):
        require(stale_launches[name] == launches[name] - ATTENTION_LAYERS,
                f"{name}: {stale_launches[name]} under stale BN vs {launches[name]}")
    step_against_plain(stale, stale_opt, stale_step, batch, stale_snap, ms)
    del stale, stale_opt, stale_step, stale_snap

    max_err = {name: 0.0 for name in WRAPPERS}
    summary = time_calls(calls, dev, launches, max_err, PATH_KERNELS, reps=3)
    summary += time_calls(stale_calls, dev, stale_launches, max_err,
                          ("pt_attn_fwd", "pt_attn_bwd"), reps=3)
    del calls, stale_calls, opt, step
    torch.cuda.empty_cache()
    # the s3dis_pt step's numbers, beside the flagship's entries
    return dict(model=model, cfg=cfg, spec=spec, batch=batch, launches=launches,
                summary=prefixed(summary, PT_BASE))


def pt_base_serve(dev, trained: dict, batch) -> None:
    """Phase 36: the eval step of phase 35's model on phase serve's crops,
    then one train step of the plain head with dropout."""
    model, cfg, spec = trained["model"], trained["cfg"], trained["spec"]
    step = make_eval_step(model, spec, dev, num_classes=cfg.data.num_classes)
    reset_counts()
    probs, _ = step(batch)
    torch.cuda.synchronize()
    counts = read_counts()
    others = {k: v for k, v in counts.items() if k not in SERVE_KERNELS and v}
    require(all(counts[k] > 0 for k in SERVE_KERNELS) and not others,
            f"request launches {counts}")
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        probs, _ = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med, peak = statistics.median(secs), torch.cuda.max_memory_allocated()
    with plain_kernels():
        plain, _ = step(batch)
    d = float((probs - plain).abs().max())
    agree = float((probs.argmax(-1) == plain.argmax(-1)).float().mean())
    print(f"{PT_BASE} request (B={probs.shape[0]} x {N}): launches "
          f"{ {k: counts[k] for k in SERVE_KERNELS} }, median of 3 {med * 1e3:.3f} ms over "
          f"{[round(x * 1e3, 3) for x in secs]}, {probs.shape[0] * N / med:.1f} points/s, "
          f"max_memory_allocated {peak} B; kernels vs plain probs max|d| {d:.3g}, argmax "
          f"agreement {agree:.6f}; card: {card_line()}", flush=True)
    require(bool(torch.isfinite(probs).all()) and d <= 1e-3 and agree >= 0.999,
            "s3dis_pt request: kernels and plain versions disagree")

    drop_cfg = load_config(PT_BASE, PT_BASE_DROPOUT)
    drop = drop_cfg.build_model(device=dev)
    drop.load_state_dict(model.state_dict())
    _, drop_step = preset_step(drop_cfg, drop, dev)
    masks, draw = [], model_blocks.dropout_mask

    def recorded_mask(key, name, rate, shape, device):
        keep = draw(key, name, rate, shape, device)
        masks.append((key, name, rate, tuple(shape), keep))
        return keep

    with mock.patch.object(model_blocks, "dropout_mask", recorded_mask):
        m = drop_step(trained["batch"])
        torch.cuda.synchronize()
    (key, name, rate, shape, keep), = masks
    on_cpu = draw(key, name, rate, shape, "cpu")
    print(f"{PT_BASE_DROPOUT}: one train step, loss {float(m['loss']):.6f}; its dropout mask "
          f"{name} {list(shape)} on the card (key {key}, the trainer's step-0 key "
          f"{dropout_key(0)}), keep share {float(keep.float().mean()):.6f}, equal to the CPU's "
          f"bit for bit: {torch.equal(keep.cpu(), on_cpu)}", flush=True)
    require(keep.is_cuda and key == dropout_key(0) and torch.equal(keep.cpu(), on_cpu),
            "the card's dropout mask is not the CPU's")
    require(np.isfinite(float(m["loss"])), "dropout step loss")


def randla_train(dev) -> None:
    """Phase 37."""
    cfg, model, opt, step = conv_setup(RANDLA, dev)
    spec = cfg.pyramid_spec()
    print(f"{RANDLA}: {sum(p.numel() for p in model.parameters())} parameters, fresh weights "
          f"(seed 0), spec {spec}; the preset's SGD (lr {cfg.optim.base_lr}, momentum "
          f"{cfg.optim.momentum}, clip {cfg.optim.grad_clip_norm})", flush=True)
    require(spec.sampler == "random", f"sampler {spec.sampler}")
    reset_counts()
    compare_pyramids(spec, grid_crop(CONV_GRID_N)["points"], dev)
    snap0 = snapshot(model, opt)
    batch, b = fitting_batch(model, opt, step, snap0, CONV_B)
    restore(model, opt, snap0)
    losses, secs = timed_steps(step, batch, 3)
    med, peak = statistics.median(secs), torch.cuda.max_memory_allocated()
    print(f"{RANDLA} train step (B={b}; the preset's {cfg.optim.batch_size}) median of 3 "
          f"{med * 1e3:.3f} ms over {[round(x * 1e3, 3) for x in secs]}, {b * N / med:.1f} "
          f"points/s, max_memory_allocated {peak} B; losses {losses}; card: {card_line()}",
          flush=True)
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"3 steps on one batch did not lower the loss: {losses}")
    eval_step = make_eval_step(model, spec, dev, num_classes=cfg.data.num_classes)
    t0 = time.perf_counter()
    probs, _ = eval_step(batch)
    torch.cuda.synchronize()
    print(f"{RANDLA} request (B={b}): {(time.perf_counter() - t0) * 1e3:.3f} ms (cold), "
          f"probs finite: {bool(torch.isfinite(probs).all())}", flush=True)
    require(bool(torch.isfinite(probs).all()), "RandLA request probs not finite")
    require_launches("the RandLA steps and request", {})


def preset_entry(root: Path, name: str, step_launches=None) -> None:
    """Phases 38-39: ``name`` through main.py on phase 24's rooms with its
    cuts, --mode train, then --mode val on the run: losses finite, each
    step's launches ``step_launches`` (no kernel where None)."""
    exp = root / f"exp_{name}"
    sets = f"data.data_root:{root / 'data'};{ENTRY_SETS}"
    print(f"main.py -c {name} --set {sets}: full width; cuts: batch "
          f"{load_config(name).optim.batch_size} -> 2, epochs 1, loop 2, num_votes 1", flush=True)
    probe = StepProbe()
    _, _, secs, total = run_entry(["-c", name, "--mode", "train", "--set",
                                   f"{sets};{ENTRY_LOG}", "--exp_dir", str(exp)], probe)
    print_probe(f"{name} train", probe)
    steps, losses = entry_losses(exp)
    print(f"--mode train: {secs:.3f} s; losses {losses} at steps {steps}; launches of the run "
          f"{ {k: v for k, v in total.items() if v} }", flush=True)
    require(len(steps) == len(probe.steps) > 0 and all(np.isfinite(losses)), f"losses {losses}")
    for i, launches in enumerate(probe.launches):
        got = {k: v for k, v in launches.items() if v}
        require(got == (step_launches or {}), f"step {i}: launches {got}, not {step_launches}")
    m, _, secs, total = run_entry(["-c", name, "--mode", "val", "--model_path", "auto",
                                   "--extra_ops", "", "--set", sets, "--exp_dir", str(exp)])
    print(f"--mode val: {secs:.3f} s, full mIoU {m['full']['mIoU']:.4f} OA {m['full']['OA']:.4f}; "
          f"launches {total}; card: {card_line()}", flush=True)
    require(np.isfinite(m["full"]["OA"]), "val OA")
    served = {k: v for k, v in total.items() if v}
    require(set(served) == (set(SERVE_KERNELS) if step_launches else set()),
            f"val launches {served}")


def windowed_searches(levels, spec, conv_levels, conv_spec) -> list:
    """(what, query, support, k, keywords) of each windowed search of the
    natural point transformer's training pyramid on ``levels`` (self,
    contrast, down, up, near0 under both top-1 tie rules, sub-scene) and of
    the ConvNet's radius searches on ``conv_levels`` (self, down)."""
    out = []
    rec = dict(recall=spec.knn_recall)
    for l, p in enumerate(levels):
        out.append((f"self L{l}", p, p, spec.k_self[l], dict(rec, ensure_self=True)))
        out.append((f"contrast L{l}", p, p, spec.k_contrast[l] - 1, dict(rec, exclude_self=True)))
        if not l:
            continue
        prev = levels[l - 1]
        out += [(f"down L{l}", p, prev, spec.k_down[l], rec),
                (f"up L{l}", prev, p, spec.k_up, rec),
                (f"near0 L{l} (last tie)", levels[0], p, 1, rec),
                (f"near0 L{l} (first tie)", levels[0], p, 1, dict(recall=None)),
                (f"sub-scene L{l}", p, levels[0], spec.subscene_k(l), rec)]
    rec = dict(recall=conv_spec.knn_recall)
    for l, p in enumerate(conv_levels):
        out.append((f"conv self L{l}", p, p, conv_spec.k_self[l],
                    dict(rec, ensure_self=True, radius=conv_spec.radii[l])))
        if l:
            out.append((f"conv down L{l}", p, conv_levels[l - 1], conv_spec.k_down[l],
                        dict(rec, radius=conv_spec.down_radii[l])))
    return out


def grid_levels(dev, spec, b: int, seed: int) -> list:
    """The level points of ``spec``'s pyramid (without its contrast and
    sub-scene searches) on b synthetic train crops of N points snapped to
    the 1/64 m grid (every distance exact), on the card."""
    batch = preset_batch(b, seed)
    pts = torch.as_tensor(np.round(batch["points"] * 64) / 64, dtype=torch.float32, device=dev)
    eval_spec = dataclasses.replace(spec, k_contrast=None, with_subscene=False)
    return list(build_pyramid(pts, eval_spec).points)


@torch.no_grad()
def windowed_kernels(dev) -> None:
    """Phase 40."""
    spec = load_config(PT_NATURAL, PT_WINDOWED).pyramid_spec()
    conv_spec = load_config(CONV_PRESETS[0], CONV_WINDOWED).pyramid_spec()
    searches = windowed_searches(grid_levels(dev, spec, B, 0), spec,
                                 grid_levels(dev, conv_spec, B, 1), conv_spec)
    win = dict(tile=spec.knn_tile, window=spec.knn_window)
    print(f"{len(searches)} windowed searches, B={B}, tile {win['tile']}, window "
          f"{win['window']} ({PT_NATURAL} and {CONV_PRESETS[0]} level shapes, 1/64 m grid); "
          f"card: {card_line()}", flush=True)
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    totals = dict(kernel=0.0, windowed=0.0, dense=0.0, bound=0.0)
    for what, q, sup, k, kw in searches:
        with recording() as calls:
            idx, d2 = knn.windowed_knn(q, sup, k, **win, **kw)
        with plain_kernels():
            p_idx, p_d2 = knn.windowed_knn(q, sup, k, **win, **kw)
        call, = calls["window_topk"]
        compare_call("window_topk", call, exact_topk=True)
        require(torch.equal(idx, p_idx) and torch.equal(bits(d2), bits(p_d2)),
                f"{what}: windowed_knn with the kernel != with the plain version")
        kern, _, _, n_bytes, n_ops, shape = call_costs("window_topk", call)
        t_k = time_ms(kern, flush_buf, reps=5)
        t_w = time_ms(lambda: knn.windowed_knn(q, sup, k, **win, **kw), flush_buf, reps=5)
        t_d = time_ms(lambda: knn.knn(q, sup, k, **kw), flush_buf, reps=5)
        bnd = bound_ms(n_bytes, n_ops)[0]
        for key, v in zip(totals, (t_k, t_w, t_d, bnd)):
            totals[key] += v
        print(f"  {what} {shape}: window_topk {t_k:.4f} ms (bound {bnd:.5f}), windowed_knn "
              f"{t_w:.4f} ms, dense knn {t_d:.4f} ms; indices and d2 equal bit for bit",
              flush=True)
    print(f"sums over the {len(searches)} searches: window_topk {totals['kernel']:.4f} ms, bound "
          f"{totals['bound']:.5f} ms, windowed_knn {totals['windowed']:.4f} ms, dense knn "
          f"{totals['dense']:.4f} ms", flush=True)


def pt_natural_windowed_train(dev, natural: dict) -> dict:
    """Phase 41."""
    cfg = load_config(PT_NATURAL, PT_WINDOWED)
    spec = cfg.pyramid_spec()
    require((spec.knn_window, spec.contrast_mode) == (3, "tile"), f"spec {spec}")
    model = pt_natural_model(cfg, dev)
    opt, step = pt_natural_step(cfg, model, dev)
    print(f"{PT_NATURAL} with {PT_WINDOWED}: spec {spec}; cut: batch {cfg.optim.batch_size} -> "
          f"{B}; SGD lr {TRAIN_LR}; card: {card_line()}", flush=True)
    snap0 = snapshot(model, opt)
    crop = grid_crop(CONV_GRID_N)
    compare_pyramids(spec, crop["points"], dev)
    card_vs_cpu_step(model, step, lambda cpu: pt_natural_step(cfg, cpu, "cpu")[1], crop)
    restore(model, opt, snap0)

    batch = natural["batch"]
    step(batch)  # warm-up
    torch.cuda.synchronize()
    restore(model, opt, snap0)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = timed_steps(step, batch, 5)
    med, peak = statistics.median(secs[2:]), torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"losses {losses}")
    require(losses[-1] < losses[0], f"5 steps on one batch did not lower the loss: {losses}")
    pts_dev = torch.as_tensor(batch["points"], device=dev)
    pyr_ms = time_ms(lambda: build_pyramid(pts_dev, spec), reps=1)
    print(f"natural windowed train step (B={B}) median of 3 warm steps {med * 1e3:.3f} ms over "
          f"{[round(x * 1e3, 3) for x in secs]}, {B * N / med:.1f} points/s, "
          f"max_memory_allocated {peak} B, pyramid {pyr_ms:.3f} ms; losses {losses}; phase "
          f"pt-natural-train's: {natural['med'] * 1e3:.3f} ms, {natural['peak']} B, pyramid "
          f"{natural['pyr_ms']:.3f} ms", flush=True)
    busy_ms = profile_request(step, batch, top=15, what="natural windowed train step")
    print(f"device busy {busy_ms:.3f} ms of the unprofiled median step {med * 1e3:.3f} ms: "
          f"busy share {busy_ms / (med * 1e3):.3f}", flush=True)

    restore(model, opt, snap0)
    reset_counts()
    with recording() as calls:
        m = step(batch)
        torch.cuda.synchronize()
    launches = require_launches("a natural windowed train step", PT_WINDOWED_STEP)
    print(f"launches in one natural windowed train step: {launches}", flush=True)
    step_against_plain(model, opt, step, batch, snap0, m)
    max_err = {name: 0.0 for name in WRAPPERS}
    summary = time_calls(calls, dev, launches, max_err, tuple(PT_WINDOWED_STEP), reps=3)
    del calls, opt, step
    torch.cuda.empty_cache()
    return dict(model=model, cfg=cfg, spec=spec, summary=prefixed(summary, "pt_natural_windowed"))


def pt_natural_windowed_serve(dev, trained: dict, root: Path, served_med: float) -> None:
    """Phase 42."""
    model, cfg, spec = trained["model"], trained["cfg"], trained["spec"]
    b = cfg.eval.batch_size
    batch = preset_batch(b, 1)
    step = make_eval_step(model, spec, dev, num_classes=cfg.data.num_classes)
    reset_counts()
    probs, _ = step(batch)
    torch.cuda.synchronize()
    launches = require_launches("a natural windowed request", PT_WINDOWED_REQUEST)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(3):
        t0 = time.perf_counter()
        probs, _ = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med, peak = statistics.median(secs), torch.cuda.max_memory_allocated()
    with plain_kernels():
        plain, _ = step(batch)
    d = float((probs - plain).abs().max())
    print(f"natural windowed request (B={b} x {N}): launches {launches}, median of 3 "
          f"{med * 1e3:.3f} ms over {[round(x * 1e3, 3) for x in secs]} (phase "
          f"pt-natural-serve's {served_med * 1e3:.3f} ms), max_memory_allocated {peak} B; "
          f"kernels vs plain probs max|d| {d:.3g}", flush=True)
    require(bool(torch.isfinite(probs).all()) and d <= 1e-4, "kernels and plain versions disagree")
    sets = (f"data.data_root:{root / 'data'};{ENTRY_SETS};data.loop:1;eval.num_votes:0;"
            f"{PT_WINDOWED};{ENTRY_LOG}")
    print(f"main.py -c {PT_NATURAL} --set {sets}: cuts batch 16 -> 2, epochs 200 -> 1, loop "
          f"30 -> 1, no epoch-end eval", flush=True)
    natural_entry_train(["-c", PT_NATURAL, "--mode", "train", "--set", sets, "--exp_dir",
                         str(root / "exp_pt_windowed")],
                        f"pt-natural-windowed entry train ({PT_NATURAL})",
                        PT_WINDOWED_STEP["fps"], PT_WINDOWED_STEP)


def conv_windowed_train(dev, conv: dict) -> dict:
    """Phase 43."""
    cfg = load_config(CONV_PRESETS[0], CONV_WINDOWED)
    model = cfg.build_model(device=dev, generator=torch.Generator().manual_seed(0))
    opt, step = preset_step(cfg, model, dev)
    spec = cfg.pyramid_spec()
    require(spec.knn_window == 3, f"spec {spec}")
    print(f"{CONV_PRESETS[0]} with {CONV_WINDOWED}: fresh weights (seed 0), spec {spec}; card: "
          f"{card_line()}", flush=True)
    reset_counts()
    crop = grid_crop(CONV_GRID_N)
    compare_pyramids(spec, crop["points"], dev)
    snap0 = snapshot(model, opt)
    card_vs_cpu_step(model, step, lambda cpu: preset_step(cfg, cpu, "cpu")[1], crop)
    restore(model, opt, snap0)
    batch, b = fitting_batch(model, opt, step, snap0, CONV_B)
    restore(model, opt, snap0)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = timed_steps(step, batch, 5)
    med, peak = statistics.median(secs[2:]), torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"losses {losses}")
    require(losses[-1] < losses[0], f"5 steps on one batch did not lower the loss: {losses}")
    pts_dev = torch.as_tensor(batch["points"], device=dev)
    pyr_ms = time_ms(lambda: build_pyramid(pts_dev, spec), reps=1)
    print(f"ConvNet windowed train step (B={b}; the preset's {cfg.optim.batch_size}) median of 3 "
          f"warm steps {med * 1e3:.3f} ms over {[round(x * 1e3, 3) for x in secs]}, "
          f"{b * N / med:.1f} points/s, max_memory_allocated {peak} B, pyramid {pyr_ms:.3f} ms; "
          f"losses {losses}; phase conv-train's (B={conv['b']}): {conv['med'] * 1e3:.3f} ms, "
          f"{conv['peak']} B, pyramid {conv['pyr_ms']:.3f} ms", flush=True)
    restore(model, opt, snap0)
    reset_counts()
    with recording() as calls:
        step(batch)
        torch.cuda.synchronize()
    launches = require_launches("a ConvNet windowed train step", CONV_WINDOWED_STEP)
    print(f"launches in one ConvNet windowed train step: {launches}", flush=True)
    del opt, step, model
    torch.cuda.empty_cache()
    max_err = {name: 0.0 for name in WRAPPERS}
    summary = time_calls(calls, dev, launches, max_err, ("window_topk",), reps=3)
    return prefixed(summary, "conv_windowed")


def contrast_window_train(dev, dense_med: float, batch_peak: int) -> list:
    """Phase 44."""
    spec = load_config(PT_FLAGSHIP, CONTRAST_WINDOW).pyramid_spec()
    require(spec == dataclasses.replace(TRAIN_SPEC, contrast_window=2), f"spec {spec}")
    print(f"{PT_FLAGSHIP} with {CONTRAST_WINDOW}: spec {spec}; card: {card_line()}", flush=True)
    train = run_train(dev, spec=spec)
    launches = train["launches"]
    require(launches["window_topk"] == CONTRAST_WINDOW_TOPK,
            f"window_topk {launches['window_topk']}, not {CONTRAST_WINDOW_TOPK}")
    widths = sorted({c[0][-2] for c in train["calls"]["cbl_stats_fwd"]})
    print(f"contrast-window step median {train['med'] * 1e3:.3f} ms, peak {train['peak']} B "
          f"beside phase train's {dense_med * 1e3:.3f} ms, {batch_peak} B; CBL window widths "
          f"(tiles) {widths}", flush=True)
    require(max(widths) == 5, f"CBL widths {widths}")
    max_err = {name: 0.0 for name in WRAPPERS}
    summary = time_calls(train["calls"], dev, launches, max_err,
                         ("window_topk", "cbl_stats_fwd", "cbl_stats_bwd"), reps=5)
    del train
    torch.cuda.empty_cache()
    return prefixed(summary, "contrast_window")


def flagship_levels(dev) -> tuple:
    """Phase 8's training pyramid (TRAIN_SPEC on its B x N batch) and the
    batch's labels in the pyramid's row order."""
    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    batch = train_batch(rooms, B, N, np.random.default_rng(0))
    pyr = build_pyramid(torch.as_tensor(batch["points"], device=dev), TRAIN_SPEC)
    labels = torch.as_tensor(batch["labels"], device=dev).long()
    return pyr, batch_gather(labels, pyr.order0)


def stats_cotangent(stats, label_soft):
    """The cotangent of the dense route's stage loss (losses/contrast.py's
    masked mean of -log(pos / under + eps)) with respect to the stats."""
    with torch.enable_grad():
        s = stats.detach().requires_grad_(True)
        pos, under, pos_cnt, valid_cnt = s.unbind(-1)[1:5]
        loss = -torch.log(pos / under.clamp_min(1e-12) + 1e-12)
        mask = ((pos_cnt > 0) & (pos_cnt < valid_cnt) & (label_soft.sum(-1) > 0)).float()
        (g,) = torch.autograd.grad((loss * mask).sum() / mask.sum().clamp_min(1.0), s)
    return g


def width_counts(calls: dict) -> dict:
    """The launches of a recorded step, by kernel and feature width (the
    last axis of the call's first tensor): {(kernel, C): n}."""
    counts = {}
    for name, cs in calls.items():
        for c in cs:
            key = (name, int(c[0][0].shape[-1]))
            counts[key] = counts.get(key, 0) + 1
    return counts


def fill_width_launches(width_summary: list, steps: list) -> None:
    """Phase 45's entries get the launches of their kernel at their width
    in the recorded steps of phases 46-47 (``steps``: width_counts of each;
    the most of any one step), 0 where no step of them runs it."""
    for entry_ in width_summary:
        kernel, c = entry_["name"].split("/", 1)[1].split("@C")
        entry_["launches"] = max(step.get((kernel, int(c)), 0) for step in steps)


def width_entries(summary: list, c: int) -> list:
    """Phase 45's entries of one width: named <kernel>@C<c>, their
    launches on the main path filled in by main() from phases 46-47."""
    for entry in summary:
        entry["name"] = f"cbl_width/{entry['name']}@C{c}"
        entry["direct_launches"], entry["launches"] = entry["launches"], 0
    return summary


@torch.no_grad()
def cbl_width_kernels(dev) -> list:
    """Phase 45."""
    pyr, labels = flagship_levels(dev)
    rng = np.random.default_rng(45)
    soft = [cbl_losses.subscene_labels(labels, pyr.subscene_idx[l], NUM_CLASSES)
            for l in range(len(PLANES))]

    def stage(l):
        tile, width = pyr.contrast_local[l]
        return pyr.contrast_idx[l], tile, width, (width - 1) // 2

    print(f"card: {card_line()}; levels {[p.shape[1] for p in pyr.points]}, contrast "
          f"geometry {[pyr.contrast_local[l] for l in range(len(PLANES))]}", flush=True)
    summary = []
    # (kernel names, widths and levels, forward, backward, the backward's cotangent)
    routes = (
        (("cbl_stats_fwd", "cbl_stats_bwd"), DENSE_WIDTH_LEVELS, cd.cbl_stats_fwd,
         cd.cbl_stats_bwd, lambda stats, l: stats_cotangent(stats, soft[l])),
        (("cbl_tile2_fwd", "cbl_tile2_bwd"), V2_WIDTH_LEVELS, c2.cbl_tile2_fwd,
         c2.cbl_tile2_bwd,
         lambda stats, l: torch.as_tensor(rng.standard_normal(B).astype(np.float32),
                                          device=dev)),
    )
    for names, width_levels, fwd, bwd, cotangent in routes:
        for c, levels in width_levels.items():
            calls = {name: [] for name in names}
            for l in levels:
                li, tile, width, window = stage(l)
                m = li.shape[1]
                feats = torch.as_tensor(rng.standard_normal((B, m, c), dtype=np.float32),
                                        device=dev)
                args = (feats, cd.row_meta(soft[l]), li, 1.0, tile, width, window)
                stats = fwd(*args)
                bwd_args = args[:3] + (stats, cotangent(stats, l)) + args[3:]
                dx = bwd(*bwd_args)
                require(dx.shape == feats.shape and bool(torch.isfinite(dx).all()),
                        f"{names[1]} C={c} L{l}: {tuple(dx.shape)}")
                calls[names[0]].append((args, {}, stats))
                calls[names[1]].append((bwd_args, {}, dx))
                k = li.shape[-1]
                if fwd is cd.cbl_stats_fwd:
                    plans = (f"fwd plan {cd.fwd_plan(B, m, k, tile, width, c)}, scatter rows "
                             f"{cd.bwd_plan(B, m, tile, c)[1]}")
                else:
                    plans = (f"{int(stats[..., 6].sum())} masked rows, plan "
                             f"{tuple(c2.fwd_plan(B, m, k, c))}, scatter rows "
                             f"{c2.bwd_plan(B, m, k, c, tile).scatter_rows}")
                print(f"  {names[0]} C={c} level {l}: M={m}, K={k}, window {tile} x {width}, "
                      f"{plans}", flush=True)
            max_err = dict.fromkeys(calls, 0.0)
            direct = {name: len(cs) for name, cs in calls.items()}
            summary += width_entries(time_calls(calls, dev, direct, max_err, names, reps=5), c)
    for c, l, nn in FUSED_GATHERS:
        li, tile, width, _ = stage(l)
        if nn:
            li = torch.cat([li, li[..., :nn]], -1)
        m = li.shape[1]
        x = torch.as_tensor(rng.standard_normal((B, m, c), dtype=np.float32), device=dev)
        starts = torch.as_tensor(window_starts(m // tile, width), dtype=torch.int32, device=dev)
        out = tg.window_gather(x, li, starts, tile, width)
        g = torch.as_tensor(rng.standard_normal(tuple(out.shape), dtype=np.float32), device=dev)
        dx = tg.window_gather_bwd(g, li, starts, tile, width, m)
        calls = {"window_gather": [((x, li, starts, tile, width), {}, out)],
                 "window_gather_bwd": [((g, li, starts, tile, width, m), {}, dx)]}
        max_err = dict.fromkeys(calls, 0.0)
        summary += width_entries(time_calls(calls, dev, dict.fromkeys(calls, 1), max_err,
                                            tuple(calls), reps=5), c)
        del x, out, g, dx, calls
        torch.cuda.empty_cache()
    return summary


def cbl_widths(calls) -> list:
    """The feature widths of recorded CBL kernel calls, in call order."""
    return [int(c[0][0].shape[-1]) for c in calls]


def cbl_fout_train(dev, dense_med: float, batch_peak: int, batch_launches: dict) -> tuple:
    """Phase 46: its entries and the width_counts of its two steps."""
    cfg = load_config(PT_FLAGSHIP, f'arch_out:"{FOUT_HEADS}"')
    contrast = cfg.contrast
    require(contrast.ftype == "f_out" and contrast.flagship_options, f"contrast {contrast}")
    print(f"{PT_FLAGSHIP} with arch_out {FOUT_HEADS}: {contrast}; the checkpoint's weights (f_out "
          f"adds none); card: {card_line()}", flush=True)
    train = run_train(dev, contrast=contrast, head_kw=dict(contrast_ftype="f_out"))
    launches = train["launches"]
    for name in ("cbl_stats_fwd", "cbl_stats_bwd"):
        widths = cbl_widths(train["calls"][name])
        require(sorted(widths) == list(PLANES), f"{name} at widths {widths}, not {PLANES}")
    for name in PATH_KERNELS:
        require(launches[name] == batch_launches[name],
                f"{name}: {launches[name]} launches vs phase train's {batch_launches[name]}")
    print(f"f_out step median {train['med'] * 1e3:.3f} ms, peak {train['peak']} B beside phase "
          f"train's {dense_med * 1e3:.3f} ms, {batch_peak} B; CBL kernel widths "
          f"{cbl_widths(train['calls']['cbl_stats_fwd'])}", flush=True)
    max_err = {name: 0.0 for name in WRAPPERS}
    summary = time_calls(train["calls"], dev, launches, max_err,
                         ("cbl_stats_fwd", "cbl_stats_bwd"), reps=3)
    steps = [width_counts(train["calls"])]

    model, opt, snap0, batch = train["model"], train["opt"], train["snap0"], train["batch"]
    del train
    with cbl_route_env("pallas"):
        step_cfg = TrainStepConfig(num_classes=NUM_CLASSES, spec=TRAIN_SPEC,
                                   contrast=dataclasses.replace(contrast, impl="pallas"))
        step = make_train_step(model, step_cfg, opt, device=dev)
        restore(model, opt, snap0)
        reset_counts()
        with recording() as calls:
            m = step(batch)
            torch.cuda.synchronize()
        counts = read_counts()
        v2 = {k: counts[k] for k in CBL_KERNELS}
        print(f"launches in one f_out step on the v2 route: {v2}", flush=True)
        require(v2 == {"cbl_stats_fwd": 0, "cbl_stats_bwd": 0, "cbl_tile2_fwd": STAGES,
                       "cbl_tile2_bwd": STAGES}, f"v2 route launches {v2}")
        require(sorted(cbl_widths(calls["cbl_tile2_fwd"])) == list(PLANES),
                f"v2 widths {cbl_widths(calls['cbl_tile2_fwd'])}")
        step_against_plain(model, opt, step, batch, snap0, m)
        summary += time_calls(calls, dev, counts, max_err, ("cbl_tile2_fwd", "cbl_tile2_bwd"),
                              reps=3)
        steps.append(width_counts(calls))
    del calls, model, opt, step
    torch.cuda.empty_cache()
    return prefixed(summary, "cbl_fout"), steps


def option_train(dev, arch_out: str, batch_launches: dict, seed: int) -> tuple:
    """Phase 47's step of one option string: fresh weights from ``seed``,
    phase 8's batch; the CBL's fused gathers' calls timed. Returns their
    entries and the step's width_counts."""
    cfg = load_config(PT_FLAGSHIP, f'arch_out:"{arch_out}"')
    contrast = cfg.contrast
    require(not contrast.flagship_options, f"{contrast} is the CBL kernels' option point")
    model = cfg.build_model(device=dev, generator=torch.Generator().manual_seed(seed))
    opt = make_optimizer(model.parameters(), TRAIN_LR)
    step = make_train_step(model, TrainStepConfig(num_classes=NUM_CLASSES, spec=TRAIN_SPEC,
                                                  contrast=contrast), opt, device=dev)
    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    batch = train_batch(rooms, B, N, np.random.default_rng(0))
    print(f"{PT_FLAGSHIP} with arch_out {arch_out}: {contrast}; fresh weights (seed {seed}); "
          f"card: {card_line()}", flush=True)
    snap0 = snapshot(model, opt)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    restore(model, opt, snap0)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = timed_steps(step, batch, 3)
    peak = torch.cuda.max_memory_allocated()
    require(all(np.isfinite(losses)), f"losses {losses}")
    require(losses[-1] < losses[0], f"3 steps on one batch did not lower the loss: {losses}")
    print(f"option step: {[round(x * 1e3, 3) for x in secs]} ms, losses {losses}, "
          f"max_memory_allocated {peak} B", flush=True)
    restore(model, opt, snap0)
    reset_counts()
    with recording() as calls:
        m = step(batch)
        torch.cuda.synchronize()
    counts = read_counts()
    print(f"launches in one option step: {counts}; metrics "
          f"{ {k: round(float(v), 6) for k, v in m.items() if k != 'confusion'} }", flush=True)
    require(all(np.isfinite(float(v)) for k, v in m.items() if k != "confusion"), f"metrics {m}")
    require(not any(counts[k] for k in CBL_KERNELS), f"a CBL kernel was launched: {counts}")
    for name in PATH_KERNELS:
        extra = STAGES if name != "window_topk" else 0  # the CBL's fused gather a stage
        require(counts[name] == batch_launches[name] + extra,
                f"{name}: {counts[name]} launches vs phase train's {batch_launches[name]} + {extra}")
    step_against_plain(model, opt, step, batch, snap0, m)
    # the gathers the plain route adds: [labels | features] rows a stage
    n_lab = 2 if contrast.pos == "cnt" else NUM_CLASSES
    width = n_lab + (cfg.model.base_fdim if contrast.project or contrast.ftype == "latent"
                     else NUM_CLASSES)
    fused = {"window_gather": [c for c in calls["window_gather"] if c[0][0].shape[-1] == width],
             "window_gather_bwd": [c for c in calls["window_gather_bwd"]
                                   if c[0][0].shape[-1] == width]}
    require(all(len(v) == STAGES for v in fused.values()),
            f"fused gathers of width {width}: { {k: len(v) for k, v in fused.items()} }")
    max_err = {name: 0.0 for name in WRAPPERS}
    summary = time_calls(fused, dev, dict.fromkeys(fused, STAGES), max_err, tuple(fused), reps=3)
    counts = width_counts(calls)
    del calls, fused, model, opt, step
    torch.cuda.empty_cache()
    return summary, counts


def option_entry(root: Path) -> None:
    """Phase 47's entry: main.py --mode train with OPTION_HEADS[0] on phase
    24's rooms (2 steps), then --mode val on that run."""
    exp = root / "exp_cbl_options"
    sets = (f"data.data_root:{root / 'data'};{ENTRY_SETS};data.loop:1;eval.num_votes:0;"
            f"{ENTRY_LOG};arch_out:\"{OPTION_HEADS[0]}\"")
    print(f"main.py -c {PT_FLAGSHIP} --mode train --set {sets}: cuts batch 16 -> 2, epochs 200 -> "
          f"1, loop 30 -> 1 (2 steps), no epoch-end eval", flush=True)
    _, built, secs, total = run_entry(["-c", PT_FLAGSHIP, "--mode", "train", "--set", sets,
                                       "--exp_dir", str(exp)])
    (model, *_), = built
    require(model.multihead.sep_head and model.multihead.project == "mlp",
            "main.py built another head")
    steps, losses = entry_losses(exp)
    print(f"train: {secs:.3f} s, losses {losses} at steps {steps}, launches {total}", flush=True)
    require(steps == [1, 2] and all(np.isfinite(losses)), f"losses {losses} at steps {steps}")
    require(not any(total[k] for k in CBL_KERNELS), f"a CBL kernel was launched: {total}")
    m, built, secs, _ = run_entry(
        ["-c", PT_FLAGSHIP, "--mode", "val", "--model_path", "auto", "--extra_ops", "",
         "--set", sets.replace("eval.num_votes:0", "eval.num_votes:0.3"), "--exp_dir", str(exp)])
    (restored, *_), = built
    live, back = model.state_dict(), restored.state_dict()
    require(live.keys() == back.keys() and all(torch.equal(live[k], back[k]) for k in live),
            "--mode val restored other weights")
    print(f"--mode val: {secs:.3f} s, {len(back)} tensors restored bit for bit; full mIoU "
          f"{m['full']['mIoU']:.4f} OA {m['full']['OA']:.4f}", flush=True)
    require(np.isfinite(m["full"]["OA"]), f"val metrics {m['full']}")


def cbl_options_train(dev, root: Path, batch_launches: dict) -> tuple:
    """Phase 47: its entries and the width_counts of its two steps."""
    summary, steps = [], []
    for i, arch_out in enumerate(OPTION_HEADS):  # strings (a) and (b)
        entries, counts = option_train(dev, arch_out, batch_launches, seed=i)
        summary += prefixed(entries, "ab"[i])
        steps.append(counts)
    option_entry(root)
    return prefixed(summary, "cbl_options"), steps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    # bfloat16 products summed in float32, as the reference's are
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    with phase("build"):
        print(f"card: {card_line()}", flush=True)
        t0 = time.perf_counter()
        lib_path = build.build()
        build.library()
        print(f"built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.3f} s", flush=True)

    ev_serve = VotingEvaluator(room0(), None, NUM_CLASSES, N, batch_size=B, voxel_size=0.04, seed=0)
    _, batch = ev_serve.next_batch(np.random.default_rng(0), ev_serve.clouds)
    del ev_serve

    with phase("kernels"):
        grid = grid_cloud(np.random.default_rng(1), B, N)
        topk_err = check_kernels(dev, [("integer grid", grid, True),
                                       ("synthetic crop", batch["points"], False)])
        check_topk_modes(dev, grid)
        check_gather_widths(dev)

    with phase("serve"):
        served = serve(dev, batch)
        step, predict, launches = served["step"], served["predict"], served["launches"]
        calls = served.pop("calls")

    with phase("timing"):
        max_err = {"window_topk": topk_err, "window_gather": 0.0}
        serve_summary = time_calls(calls, dev, launches, max_err, SERVE_KERNELS)
        time_spread(calls, dev, ("window_topk",))
        del calls

    with phase("profile"):
        pts_dev = torch.as_tensor(batch["points"], device=dev)
        pyr_ms = time_ms(lambda: build_pyramid(pts_dev, PyramidSpec()), reps=3)
        step_ms = time_ms(lambda: step(batch), reps=3)
        print(f"device time: pyramid {pyr_ms:.3f} ms, whole step {step_ms:.3f} ms", flush=True)
        profile_request(step, batch)

    with phase("voting"):
        voting(predict)

    with phase("stale-serve"):
        stale_served = serve(dev, batch, "stale", served["probs"])
        n_fwd = stale_served["launches"]["pt_attn_fwd"]
        require(n_fwd == ATTENTION_LAYERS, f"pt_attn_fwd: {n_fwd} launches, not {ATTENTION_LAYERS}")
        print(f"stale request median {stale_served['med'] * 1e3:.3f} ms beside the batch-BN "
              f"request's {served['med'] * 1e3:.3f} ms", flush=True)
        voting(stale_served["predict"], "stale request")
        records = []
        stale_summary = time_calls(stale_served.pop("calls"), dev, stale_served["launches"],
                                   {"pt_attn_fwd": 0.0}, ("pt_attn_fwd",), records=records)
        print_widths(records)
    f32_serve = dict(probs=served["probs"], med=served["med"], peak=served["peak"],
                     launches=served["launches"])
    stale_serve = dict(probs=stale_served["probs"], launches=stale_served["launches"])
    del served, stale_served, step, predict
    torch.cuda.empty_cache()

    with phase("train"), cbl_route_env("dense"):
        train = run_train(dev)

    with phase("train-kernels"), cbl_route_env("dense"):
        train_summary = check_train_kernels(dev, train)
    batch_launches, batch_peak = train["launches"], train["peak"]
    dense_med, dense_metrics = train["med"], train["metrics"]
    f32_steps = {"batch": {k: train[k] for k in ("loss", "grad_norm", "med", "peak", "busy_ms")}}
    del train
    torch.cuda.empty_cache()

    with phase("stale-train"), cbl_route_env("dense"):
        stale = run_train(dev, "stale")
        launches = stale["launches"]
        for name in ("pt_attn_fwd", "pt_attn_bwd"):
            require(launches[name] == ATTENTION_LAYERS,
                    f"{name}: {launches[name]} launches, not {ATTENTION_LAYERS}")
        for name in ("window_gather", "window_gather_bwd"):
            require(launches[name] == batch_launches[name] - ATTENTION_LAYERS,
                    f"{name}: {launches[name]} launches under stale BN vs "
                    f"{batch_launches[name]} under batch BN")
        print(f"peak memory of the stale step {stale['peak']} B vs the batch step {batch_peak} B",
              flush=True)

    with phase("stale-kernels"), cbl_route_env("dense"):
        train_summary += check_stale_kernels(dev, stale)
    f32_steps["stale"] = {k: stale[k] for k in ("loss", "grad_norm", "med", "peak", "busy_ms")}
    del stale
    torch.cuda.empty_cache()

    route_metrics = {"dense": dense_metrics}
    with phase("cbl-xla"), cbl_route_env("xla"):
        xla = run_train(dev, route="xla")
        for name in ("window_gather", "window_gather_bwd"):
            require(xla["launches"][name] == batch_launches[name] + STAGES,
                    f"{name}: {xla['launches'][name]} launches on the XLA tile route vs "
                    f"{batch_launches[name]} on the dense route")
        print(f"XLA tile route: step median {xla['med'] * 1e3:.3f} ms vs the dense route's "
              f"{dense_med * 1e3:.3f} ms, peak memory {xla['peak']} B vs {batch_peak} B",
              flush=True)
        route_metrics["xla"] = xla["metrics"]
    del xla
    torch.cuda.empty_cache()

    with phase("cbl-pallas"), cbl_route_env("pallas"):
        pallas = run_train(dev, route="pallas")
        for name in PATH_KERNELS:
            require(pallas["launches"][name] == batch_launches[name],
                    f"{name}: {pallas['launches'][name]} launches on the v2 route vs "
                    f"{batch_launches[name]} on the dense route")
        print(f"v2 route: step median {pallas['med'] * 1e3:.3f} ms vs the dense route's "
              f"{dense_med * 1e3:.3f} ms, peak memory {pallas['peak']} B vs {batch_peak} B",
              flush=True)
        route_metrics["pallas"] = pallas["metrics"]
        check_routes(route_metrics)

    with phase("cbl-kernels"):
        train_summary += check_cbl_kernels(dev, pallas)
    del pallas
    torch.cuda.empty_cache()

    with phase("plan-shapes"):
        check_plan_shapes(dev)

    def bf16_serve(bn_mode):
        out = serve(dev, batch, bn_mode, f32_serve["probs"], dtype=BF16)
        print(f"bfloat16 request ({bn_mode} BN): median {out['med'] * 1e3:.3f} ms, peak memory "
              f"{out['peak']} B, beside the float32 batch-BN request's {f32_serve['med'] * 1e3:.3f}"
              f" ms, {f32_serve['peak']} B", flush=True)
        voting(out["predict"], f"bfloat16 {bn_mode}-BN request", steps=1)
        return out

    def bf16_train(bn_mode):
        out, ref = run_train(dev, bn_mode, dtype=BF16), f32_steps[bn_mode]
        print(f"bfloat16 vs float32 step ({bn_mode} BN), same weights and batch: loss "
              f"{out['loss']:.7f} vs {ref['loss']:.7f} (rel "
              f"{abs(out['loss'] - ref['loss']) / abs(ref['loss']):.3g}), gradient norm "
              f"{out['grad_norm']:.7f} vs {ref['grad_norm']:.7f} (rel "
              f"{abs(out['grad_norm'] - ref['grad_norm']) / ref['grad_norm']:.3g})", flush=True)
        print(f"bfloat16 step ({bn_mode} BN): median {out['med'] * 1e3:.3f} ms, peak memory "
              f"{out['peak']} B, busy share {out['busy_ms'] / (out['med'] * 1e3):.3f}; float32 "
              f"step of this run: {ref['med'] * 1e3:.3f} ms, {ref['peak']} B, busy share "
              f"{ref['busy_ms'] / (ref['med'] * 1e3):.3f}; PERF.md's float32 step: "
              f"{F32_STEP_PERF}", flush=True)
        return out

    bf16_launches, bf16_served = {}, {}

    def keep_served(out):
        return {k: out[k] for k in ("probs", "launches", "by_dtype")}

    with phase("bf16-serve"):
        out = bf16_serve("batch")
        require_bf16_counts(out["by_dtype"], {"window_gather": {"bfloat16": ATTENTION_LAYERS}},
                            "a bfloat16 batch-BN request")
        bf16_served["batch"] = keep_served(out)
        del out
    with phase("bf16-train"), cbl_route_env("dense"):
        bf16_step = bf16_train("batch")
        require_bf16_counts(bf16_step["by_dtype"], BF16_STEP_GATHERS, "a bfloat16 batch-BN step")
        bf16_calls = bf16_calls_on_host(bf16_step["calls"],
                                        ("window_gather_bf16", "window_gather_bwd_bf16"))
        for name in ("window_gather", "window_gather_bwd"):
            bf16_launches[f"{name}_bf16"] = bf16_step["by_dtype"][name]["bfloat16"]
        del bf16_step
    torch.cuda.empty_cache()
    with phase("bf16-stale"), cbl_route_env("dense"):
        out = bf16_serve("stale")
        require_bf16_counts(out["by_dtype"], {"pt_attn_fwd": {"bfloat16": ATTENTION_LAYERS}},
                            "a bfloat16 stale request")
        bf16_served["stale"] = keep_served(out)
        del out
        stale_bf16 = bf16_train("stale")
        attn = {"bfloat16": ATTENTION_LAYERS, "float32": 0}
        require_bf16_counts(stale_bf16["by_dtype"], {"pt_attn_fwd": attn, "pt_attn_bwd": attn},
                            "a bfloat16 stale step")
        bf16_calls.update(bf16_calls_on_host(stale_bf16["calls"],
                                             ("pt_attn_fwd_bf16", "pt_attn_bwd_bf16")))
        for name in ("pt_attn_fwd", "pt_attn_bwd"):
            bf16_launches[f"{name}_bf16"] = stale_bf16["by_dtype"][name]["bfloat16"]
        del stale_bf16
    torch.cuda.empty_cache()
    with phase("bf16-kernels"), cbl_route_env("dense"):
        bf16_summary = check_bf16_kernels(dev, bf16_calls, bf16_launches)
    del bf16_calls
    torch.cuda.empty_cache()

    with phase("eval-features"):
        print(f"card: {card_line()}", flush=True)
        feat = eval_features(dev, batch, f32_serve)
        stale_feat = eval_features(dev, batch, stale_serve, "stale")
        n_fwd = stale_feat["launches"]["pt_attn_fwd"]
        require(n_fwd == ATTENTION_LAYERS, f"pt_attn_fwd: {n_fwd} launches, not {ATTENTION_LAYERS}")
        f32_feats = {"batch": feat["feats"], "stale": stale_feat["feats"]}
        del stale_feat, stale_serve
    with phase("voting-features"):
        print(f"card: {card_line()}", flush=True)
        voting_features(dev, feat["model"])
    with phase("enumerate"):
        print(f"card: {card_line()}", flush=True)
        enumerate_room(dev, feat["model"], CKPT.exists())
    del feat
    torch.cuda.empty_cache()
    with phase("bf16-eval-features"):
        print(f"card: {card_line()}", flush=True)
        for mode in ("batch", "stale"):
            out = eval_features(dev, batch, bf16_served[mode], mode, BF16, f32_feats[mode])
            del out
        del bf16_served, f32_feats
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="cbl_entry_") as tmp:
        root = Path(tmp)
        with phase("train-entry"), cbl_route_env("dense"):
            print(f"card: {card_line()}", flush=True)
            (root / "data").mkdir()
            t0 = time.perf_counter()
            write_s3dis_rooms(root / "data")
            print(f"wrote {ENTRY_ROOMS} + 1 rooms of {ENTRY_POINTS} points in "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            train_entry(dev, root, batch, batch_launches)
        torch.cuda.empty_cache()
        with phase("train-entry-bf16"), cbl_route_env("dense"):
            print(f"card: {card_line()}", flush=True)
            train_entry_bf16(root)
        torch.cuda.empty_cache()
        with phase("prepare-test"), cbl_route_env("dense"):
            print(f"card: {card_line()}", flush=True)
            prepare_test(root, f32_serve["launches"], batch_launches)
        torch.cuda.empty_cache()
        with phase("conv-train"):
            print(f"card: {card_line()}", flush=True)
            conv = conv_train(dev)
        with phase("conv-serve"):
            conv_serve(dev, conv)
        conv_ref = {k: conv[k] for k in ("med", "peak", "pyr_ms", "b")}
        del conv
        torch.cuda.empty_cache()
        with phase("conv-entry"):
            print(f"card: {card_line()}", flush=True)
            conv_entry(root)
        torch.cuda.empty_cache()
        with phase("pt-natural-train"):
            print(f"card: {card_line()}", flush=True)
            natural = pt_natural_train(dev)
        with phase("pt-natural-serve"):
            natural_ref = {k: natural[k] for k in ("batch", "med", "peak", "pyr_ms")}
            natural_ref["serve_med"] = pt_natural_serve(dev, natural)
        fps_summary, levels = natural["summary"], natural["levels"]
        del natural
        torch.cuda.empty_cache()
        with phase("pt-natural-entry"):
            print(f"card: {card_line()}", flush=True)
            pt_natural_entry(root, levels)
        torch.cuda.empty_cache()
        with phase("dp-gloo"), cbl_route_env("dense"):
            dp_compare(dev, root / "dp_gloo", 2, "gloo", "cuda:0")
        torch.cuda.empty_cache()
        with phase("dp-nccl"), cbl_route_env("dense"):
            dp_nccl(dev, root)
        torch.cuda.empty_cache()
        with phase("pt-base-train"):
            print(f"card: {card_line()}", flush=True)
            pt_base = pt_base_train(dev)
        with phase("pt-base-serve"):
            pt_base_serve(dev, pt_base, batch)
        pt_base_summary, pt_base_step = pt_base["summary"], pt_base["launches"]
        del pt_base
        torch.cuda.empty_cache()
        with phase("randla-train"):
            print(f"card: {card_line()}", flush=True)
            randla_train(dev)
        torch.cuda.empty_cache()
        with phase("pt-base-entry"):
            preset_entry(root, PT_BASE, pt_base_step)
        torch.cuda.empty_cache()
        with phase("randla-entry"):
            preset_entry(root, RANDLA)
        torch.cuda.empty_cache()
        with phase("windowed-kernels"):
            windowed_kernels(dev)
        torch.cuda.empty_cache()
        with phase("pt-natural-windowed-train"), cbl_route_env("dense"):
            windowed = pt_natural_windowed_train(dev, natural_ref)
        with phase("pt-natural-windowed-serve"), cbl_route_env("dense"):
            pt_natural_windowed_serve(dev, windowed, root, natural_ref["serve_med"])
        windowed_summary = windowed["summary"]
        del windowed, natural_ref
        torch.cuda.empty_cache()
        with phase("conv-windowed-train"):
            windowed_summary += conv_windowed_train(dev, conv_ref)
        torch.cuda.empty_cache()
        with phase("contrast-window-train"), cbl_route_env("dense"):
            windowed_summary += contrast_window_train(dev, dense_med, batch_peak)
        torch.cuda.empty_cache()
        with phase("cbl-width-kernels"):
            width_summary = cbl_width_kernels(dev)
        torch.cuda.empty_cache()
        with phase("cbl-fout-train"), cbl_route_env("dense"):
            fout_summary, fout_steps = cbl_fout_train(dev, dense_med, batch_peak,
                                                      batch_launches)
        torch.cuda.empty_cache()
        with phase("cbl-options-train"), cbl_route_env("dense"):
            options_summary, option_steps = cbl_options_train(dev, root, batch_launches)
    torch.cuda.empty_cache()
    fill_width_launches(width_summary, fout_steps + option_steps)

    summary = []
    for entry in train_summary:
        per_request = next(
            (e for e in serve_summary + stale_summary if e["name"] == entry["name"]), None)
        if per_request is None:
            summary.append(entry)
        else:
            summary.append({**per_request, "train": {k: entry[k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}})
    summary += bf16_summary  # per bfloat16 train step
    summary.append(fps_summary)  # per natural train step
    summary += pt_base_summary  # per s3dis_pt train step (batch BN; the attention's stale)
    summary += windowed_summary  # per step of phases 41, 43 and 44
    summary += width_summary + fout_summary + options_summary  # phases 45-47
    print(f"total {time.perf_counter() - t_start:.3f} s", flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:
        sys.exit(dp_rank(Path(sys.argv[2]), sys.argv[3], sys.argv[4]))
    if sys.argv[1:2] == ["--nccl-rank"]:
        sys.exit(nccl_rank())
    sys.exit(main())
