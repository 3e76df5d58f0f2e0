#!/usr/bin/env python3
"""chip_smoke — drive the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--repeats N] [--wrapper-host-ms]

``--wrapper-host-ms`` only builds the kernels and prints the flash and SSD
wrappers' ``host_ms`` (below), three rounds each, for the ``src`` beside
the script: a copy of the script beside another checkout's ``src`` times
that checkout's wrappers, so two checkouts compare on one machine.

Runs the paper's two memory-bound apps through the port's entry points
(``repro_torch.core.apps.histogram`` / ``kmeans``) at the benchmarks' full
widths, on data generated on the card from ``--seed``: 8 locations × 16
blocks × 262,144 rows (33,554,432 rows, round-robin placement); histogram
at d=5, bins=8; k-means at d=20, k=8, 10 iterations, over 8 tight Gaussian
blobs (σ=0.02).  Five policies — Baseline, SplIter(1, scan),
SplIter(1, pallas), SplIter(2) (fusion "auto": the kernel on a card) and
Rechunk — must agree: histograms exactly, with a total equal to the row
count; k-means counts exactly and centers to 1e-4 relative.

On the fused path the histogram kernel reads each partition's blocks where
they lie: a SplIter(1, pallas) histogram pass must raise
``torch.cuda.max_memory_allocated`` by less than one partition's bytes
(16 × 262,144 × 5 × 4 = 83,886,080), which a copy of the blocks would take.

Then each hand-written kernel runs at the main path's per-task shape
(16 × 262,144 rows: the partition's block list for the histogram, as the
main path passes it; stacked for k-means, whose wrapper stacks the list)
beside its plain PyTorch version, compared with a stated tolerance and
timed with CUDA events.  Kernel launches are counted over the main-path
phase only.

Timing: a kernel's ``ms`` (and ``plain_ms``, ``library_ms`` and the other
times) is one call between two CUDA events on an idle card, so the host's
work to launch the call is in it.  Beside ``ms``, ``device_ms`` is the
card's time per call with the calls queued behind a sleeping kernel, so
that the card runs them back to back and the host's launch work is hidden,
and ``host_ms`` is that launch work per call on the host's clock.

More paths follow, each with every launch count set to 0 just before it and
read just after:

* ``threaded``: on the main path's data, the histogram under
  SplIter(1, pallas) and SplIter(2) and the 10-iteration k-means under
  SplIter(1, pallas), barriered and with ``pipeline=True``, each on a
  ``ThreadedExecutor`` (one worker thread per location) beside a
  ``LocalExecutor``: histograms and k-means centers bit-identical, counts,
  dispatches, merges, traces, bytes moved and granularity equal, the same
  kernel launches per call (8 per pass, 80 per run at SplIter(1)),
  ``overlapped_launches`` > 0 on pipelined iterations 2–10, and every
  worker thread joined after ``close()``; the wall medians print beside
  Local's.
* ``stream``: on the same data, both apps streamed from disk through a
  ``DiskStore`` on the card whose budget is a quarter of the data
  (167,772,160 B for the histogram, two of its SplIter(1) partitions of
  83,886,080 B; 671,088,640 B for k-means), on a ``StreamExecutor`` with
  ``prefetch_depth`` 1 and 0.  The histogram under SplIter(1, pallas) and
  SplIter(2), a fresh store each: one cold pass (its evictions write the
  spill files) and three warm ones; k-means under SplIter(1, pallas) for
  3 iterations (cut from 10 for the time limit), barriered and then with
  ``pipeline=True`` on one store.  Against a ``LocalExecutor`` on the
  in-memory data: histograms, k-means centers and counts bit-identical;
  dispatches, merges, traces, bytes moved and granularity equal; one
  kernel launch per partition; ``bytes_spilled`` > 0 on the cold pass,
  ``bytes_loaded`` > 0, ``prefetch_hits`` > 0 exactly when prefetching;
  ``overlapped_launches`` > 0 on pipelined iterations 2–3; the store's peak
  resident bytes at most 1.25 × the budget; the device memory a store's
  runs take (``max_memory_allocated`` after a reset, less the allocation
  before the store) at most 1.25 × the budget + one partition (k-means's
  stacked operand) + 16 MiB, each term printed; the spill directory gone
  after ``close()``.  One more histogram pass on a ``ThreadedExecutor``
  over a DiskStore copy must equal Local's.  Each line prints the walls
  beside Local's in-memory wall, GB loaded and spilled, and the load rate;
  the kernels line gives the launches of the StreamExecutor runs as
  ``stream_launches``.
* ``mesh``: on the same data, both apps through ``engine("mesh")`` at one
  rank (``cuda:0``) and at eight (``devices=(cuda:0,) * 8``: eight ranks on
  the one card), beside a ``LocalExecutor``: the histogram under Baseline,
  SplIter(1, scan), SplIter(1, pallas), SplIter(2) and Rechunk, k-means
  under SplIter(1, pallas).  Histogram counts equal Local's exactly; k-means
  counts equal, centers bit-identical where the mesh's fold has Local's
  association (each line prints ``same_association_as_local``), within the
  reference's 2e-4 elsewhere; one sharded dispatch per SplIter pass and per
  k-means iteration; ``merges`` 0 and ``bytes_moved`` Local's at one rank,
  ``merges`` 1 and Local's + 7 × the partial's bytes at eight (917,504 B a
  histogram pass, 4,704 B a k-means iteration); kernel launches per pass
  equal Local's; device memory rises in a pass by at most Local's rise +
  4 MiB (nothing is stacked along the group axis).  Walls: medians of 3
  warm passes beside Local's.  The value histogram runs once on an
  eight-rank mesh, its ``partition_histogram`` kernel reached through the
  partition-kernel registry: 8 launches, equal to ``histogram_ref``.
* ``service``: through ``engine("server", server_backend="local"|"mesh")``:
  two ``JobClient`` tenants, weights 2:1, run histogram passes and a
  10-iteration k-means at the same width on an in-memory server, every
  value equal to the direct Local call's bit for bit (the unit slots each
  tenant took while both had work are printed); three histogram jobs per
  tenant submitted before the scheduler starts, where the weight-2 tenant
  must run twice the other's units, within two; a durable histogram job
  (``root`` a temporary directory) with ``fsync`` on and off: the payload's
  encoding, the submission (which journals the 671,088,640 B of blocks) and
  the job's wall after it, beside the direct call's.  Last, a durable
  histogram job on the ``local`` backend is ``kill()``ed after two units
  and a fresh server resumes it: restored + recomputed units equal the
  total, the value equals the direct call's, the inputs were rebuilt on
  the card, and the resumed task units launched ``partition_histogramdd``.
* ``cluster``: on the same data, ``engine("cluster")`` with one spawned
  worker process per location (8), each computing on the card in its own
  CUDA context, operands through POSIX shared memory, beside a
  LocalExecutor.  ``/dev/shm`` must hold twice the exports (both datasets,
  3,355,443,200 B); the rows per block are cut only if it does not, and the
  setup line prints the free space and any cut.  The histogram under
  SplIter(1, pallas) and Baseline, a first pass (spawn, contexts, export)
  and ``--repeats`` warm ones: counts equal Local's; bytes moved and
  granularity equal; no retries; the dataset's bytes exported on the first
  pass only; 8 ``partition_histogramdd`` launches a fused pass counted in
  the workers (read with ``ClusterExecutor.call_workers``), none in the
  driver; each pass's seconds split into export, the workers' operand
  copies, compute, replies and folds (``cluster_worker.unit_stats``).  The
  fused passes bill Local's dispatches and merges, ``remote_dispatches`` =
  the tasks and ``shm_bytes`` = exports + one 131,072 B reply a task.  The
  Baseline passes are folded by the peer exchange under the default
  ``p2p="auto"`` (the fused passes have shown the merge's 131,072 B
  partials): the reference's bill, Local's dispatches and merges + 8 fold
  units, ``remote_dispatches`` = tasks + 8, ``shm_bytes`` = the 128
  published partials + 8 fold replies, ``p2p_bytes`` = 128 × 131,072 B,
  ``driver_merge_bytes`` = 8 × 131,072 B, 8 folds in the workers'
  ``unit_stats``.  The workers' partials equal
  the plain versions (histogram exactly; k-means counts, sums to 1e-4).
  k-means under SplIter(1, pallas), 10 iterations: 80 ``partition_kmeans``
  launches in the workers, centers bit-identical to Local's (the driver
  folds with Local's plan).  Per-worker device memory.  Then a fresh pool
  whose worker 3 dies after its first unit of a SplIter(2) pass (its lost
  unit replays on a survivor, bit-identical, ``retries`` 1) and one under
  ``ChaosSchedule(seed=11)`` over the 8 owners with stealing (a kill, a
  straggler, a grow and a shrink; every round bit-identical, steals,
  retries and scale events equal to the logs, every pin released).  Then
  the peer exchange forced on (``p2p=True``) on a fresh pool under
  SplIter(2, pallas): the histogram (16 launches and 8 fold units of
  fan-in 2 a pass, ``p2p_bytes`` 2,097,152 B and ``driver_merge_bytes``
  1,048,576 B where the pinned pass above billed 2,097,152 B, counts equal
  Local's and the plain version's) and a 10-iteration k-means (160
  ``partition_kmeans`` launches and 80 folds in the workers, 16 × 672 B
  peer-side and 8 × 672 B at the driver an iteration, centers bit-identical
  to Local's SplIter(2), one folded partial equal to Local's and the plain
  version's); and a fresh p2p pool whose worker 3 dies on receiving its
  fold (the fold replays, bit-identical, the bill exact).  After each
  ``close()`` no segment (published partials included) is left in
  ``/dev/shm`` and no worker process lives.  The kernels line gives the
  workers' launches as ``cluster_launches``.
* ``value_histogram``: ``repro_torch.kernels.ops.partition_histogram`` (bins
  128) over each location's stacked partition of the histogram data; the
  summed counts must equal ``kernels.ref.histogram_ref`` bit for bit.
* ``serve`` for qwen3-32b at full width (d_model 5120, 64/8 heads of 128,
  d_ff 25,600, vocab 151,936) with ``attn_impl="flash"`` and depth cut to 4
  of 64 layers, and for mamba2-1.3b at full width, depth cut to 8 of 48
  (``SERVE_QWEN3_LAYERS``, ``SERVE_MAMBA2_LAYERS``: the time limit):
  ``repro_torch.runtime.Server.generate`` on random bf16 weights drawn on the
  card from ``--seed``, batch 8, prompts of 512 random tokens, 32 greedy
  decode steps, ``max_len`` 576.  The prefill must launch the model's kernel
  (``flash_attention`` or ``ssd_scan``) once per layer.  Checks: every
  logit finite; the prefill's last-position logits and every served
  decode step's logits agree with the token-by-token recurrence (the same
  tokens fed one at a time through ``decode_step`` from an empty cache:
  plain PyTorch, another algorithm) within ``LOGIT_TOL``; for qwen3 the
  ``flash`` and ``ref`` attention routes give the same prefill logits within
  ``LOGIT_TOL``; each served token is the recurrence's argmax, except where
  the two tokens' recurrence logits are within ``LOGIT_TOL`` (a near-tie).
  ``LOGIT_TOL`` is per run (``SERVE``).  The prefill and the recurrence
  run again in f32 on the same weights upcast (mamba2's prefill through its
  kernel in f32; qwen3's through the flash kernel's split route, once per
  layer) and must agree within ``F32_LOGIT_TOL``.  A third serve
  run, mamba2-1.3b at full width cut to 2 layers, holds the bf16 SSD route
  to the same checks at a tolerance of 0.25, which 8 random layers' bf16
  rounding does not allow.  Three more runs take the dense configs' other
  layer branches through the same checks at full width cut to 1 layer, 8
  decode steps, ``attn_impl="flash"`` (head dim 128: the ``wgmma`` route):
  qwen2-72b (QKV bias), command-r-35b (parallel block, layernorm, tied
  embeddings) and deepseek-7b (MHA, 32 heads of 128 for keys and values).
  Each row's kernel launches are counted from the config's segments:
  ``flash_attention`` once per attention layer under ``attn_impl="flash"``,
  ``ssd_scan`` once per Mamba2 layer; its f32 prefill launches the flash
  split route once per attention layer.  The prefill's matrix-product bound
  sums every segment's parameters, an MoE layer's experts counted as a token
  uses them (``ModelConfig.param_counts()["active"]``).
* ``serve`` for the MoE configs at full width, batch 8, 512-token prompts,
  8 decode steps, bf16, on random weights from ``--seed``: mixtral-8x7b cut
  to 1 of 32 layers and jamba-v0.1-52b to one period (8 of 32: 7 Mamba2
  layers, one attention layer, 4 MoE MLPs), both with
  ``attn_impl="flash"``; deepseek-v2-236b cut to 2 of 60 (its dense first
  layer and one MoE layer; MLA, no kernel).  The dropless row runs at
  capacity factor E/k (4, 8, 160/6), where no group drops a token: the
  prefill must launch ``flash_attention`` 1 / 1 / 0 times and ``ssd_scan``
  0 / 7 / 0 times; ``moe_mlp``'s route recorder takes every layer's routes
  in the served run and in the recurrence, and ``route_mismatches`` counts
  per MoE layer the positions routed apart (a near-tie of bf16-rounded
  router probabilities).  The bf16 prefill, decode and argmax checks hold
  every compared position whose own routes agree in every layer, within the
  row's ``logit_tol`` (``MOE_SERVE``); positions routed apart are printed
  with their errors and may be at most ``ROUTE_FLIP_SHARE`` of those
  compared.  Then the bf16 weights are upcast leaf by leaf, and the f32
  prefill, the f32 decode steps over the served tokens and the f32
  recurrence must agree at every position within ``F32_LOGIT_TOL``.  The
  published row runs the same weights at the configs' capacity factor 1.25:
  prefill and decode times, the bounds, the onehot path's expert work at its
  capacity, the dropped (token, choice) pairs of the prefill and of each
  decode step, memory; checked: finite logits, dispatches, launches.
* ``serve`` for the cross-attention configs at full width, batch 8,
  512-token prompts, 8 decode steps, bf16, ``attn_impl="flash"``, every
  cross layer's gate set to 1 (``CROSS_SERVE``): whisper-tiny whole (4
  encoder and 4 decoder layers, frames 8×1500×384) and
  llama-3.2-vision-11b cut to two periods (10 of 40 layers: 8 self- and 2
  cross-attention layers; image embeddings 8×1600×4096, passed again at
  every decode step), through ``Server.generate(extras=...)``.  The prefill
  must launch ``flash_attention`` once per attention layer, the encoder's
  and cross-attention's included (12 and 10), and its f32 prefill the
  split route and ``split_kv`` as often.  Checks as the other serve rows:
  finite logits, the prefill and every decode step against the recurrence
  handed the same memory (the encoder's output, or the image embeddings),
  the flash route against the ref route, the served tokens the
  recurrence's argmax except at near-ties, all within the row's tolerance;
  f32 within ``F32_LOGIT_TOL``; and the same prefill with every gate at 0
  must differ by more than the tolerance.  The prefill's matrix-product
  bound counts ``wk_mem``/``wv_mem`` over the memory tokens and the
  encoder's parameters over the frames; the decode bytes bound leaves out
  the encoder; the vlm's re-projection of its memory at every step is
  printed beside it.
* ``sampled_serve``: mamba2-1.3b cut to 2 layers, ``greedy=False``, 8
  steps: each token after the first is ``_threefry.categorical`` (the
  reference's ``jax.random.categorical`` bits) of its step's served
  logits, and a second run gives the same tokens.
* ``knn`` at ``benchmarks/bench_knn.py``'s width (d = 3, k = 8): 8
  locations × 16 blocks × 8,192 fit rows, 8 × 2 × 512 queries, under
  Baseline, SplIter(1), SplIter(2) and Rechunk on both executors: Local
  and Threaded bit-identical; the policies name the same neighbors up to
  equal distances; distances within 1e-4 of a brute force on the card;
  duplicated fit rows give the CPU's ids; SplIter below Baseline in
  dispatches and merges.
* ``svm`` at ``benchmarks/bench_svm.py``'s full mode's data: 8 locations ×
  8 blocks × 512 rows, d = 8, 32 SVs, 100 steps (the quick mode's; the full
  mode's 300 cut for the time limit), 2 iterations, under the same
  policies: support vectors bit-identical between the executors, each an
  actual (x, y) pair; training accuracy above 0.85 at 128 SVs and c = 10
  on the data of the reference's test (``tests/test_core_apps.py:109``;
  at this phase's size 128 SVs underfit, in the reference as here, and the
  accuracy is printed); SplIter below Baseline in dispatches.
* ``moe``: one MoE layer of mixtral-8x7b (8 experts split into 16 virtual
  ones) and of jamba-v0.1-52b (16 experts) at full width and capacity
  factor 1.25: ``moe_mlp`` against the plain per-expert version
  (``repro_torch.models.moe_ref.moe_plain``: argmax top-k, sort-ranked
  slots, per-expert gathers) on 4096 tokens in groups of 1024 (tilted by
  one shared random row, so the capacity drops choices) and on 8
  decode-sized groups of 8 tokens.  In f32 on the upcast inputs the drop
  sets are equal and the outputs within ``F32_TOL``; in bf16 the outputs
  within ``BF16_TOL`` where the routes agree; the decode-sized groups must
  drop.  Drop counts and both versions' times print.

Then each of the three LM-path kernels runs beside its plain version at the
serving path's shapes: ``flash_attention`` (q 8×512×64×128, k/v
8×512×8×128, bf16, causal; also a fully masked-row case, a 4096 window on
6144 tokens, head dims 64 and 32, a ragged Lq = 500, group 1 and mixtral's
and jamba's 32 / 8 heads, each timed
beside ``scaled_dot_product_attention``; the encoder's and cross-attention's
calls, not causal, Lk 1500 or 1600 (``CROSS_FLASH_SHAPES``), in bf16 and
in f32, each with its bound, plain version and SDPA; and its split route in
f32 at the same shapes within ``F32_TOL``; with q and k at 1, 2, 3, 4 and 6 times the
scale beside the plain version in f64 and the kernel's arithmetic emulated
with f32 products, within ``F32_TOL`` of the f32 plain version at 2 and of
the f64 one at 3; and in bf16 at head dim 16), ``ssd_scan`` (x 8×512×64×64, B/C
8×512×128; in f32 on upcast inputs and on f32 inputs that are not bf16
values within ``SSD_TOL``, and on the bf16 inputs y within ``BF16_TOL`` and
the f32 state within ``SSD_TOL`` of the same f32 plain version; and at
jamba's layer, x 8×512×128×64, B/C 8×512×16, the same checks, times and
bound) and
``partition_histogram`` (16×262,144×5 f32, bins 128, bit-exact and the same
bits on a second launch, timed beside ``torch.histc`` as a yardstick).
``partition_kmeans`` must also give the same bits on a second launch.  Each
kernel's entry gives its launches on its path's run and per call of its
path; ``launches`` sums its launches over the serve runs, and
``launches_by_run`` gives each run's.

The kernels line gives each kernel's launches on the mesh, service and
cluster runs as ``mesh_launches``, ``service_launches`` and
``cluster_launches`` (null for a kernel not on those paths).

* ``train``: the SplIter trainer (``repro_torch.runtime.Trainer``) on the
  card, bf16 compute over f32 master weights and moments, every launch count
  set to 0 before the phase and read after it.  lm100m whole (the
  reference's ~100M preset: 12 layers, d 768, vocab 32000, 162.4M
  parameters, remat none, ``attn_impl="flash"``): global batch 32 in 4
  blocks of 8 sequences of 1024, peak lr 1e-3 after 2 warm-up steps, 12
  steps in each of ``spliter``, ``per_block`` and ``materialized`` from the
  same params; per mode ms per step (median of the last 10), tokens/s,
  dispatches per step (1 / 5 / 1), peak memory, first and last losses and
  the step's matmul-FLOP bound, and one more step under ``torch.profiler``
  (the card's busy time, the idle share of the unprofiled step, the top
  kernels, and the launch sites of the top six);
  the loss falls (mean of the last 4 below
  the first 4), the first-step losses agree within 1e-3 relative and the
  three modes' f32 gradients of step 1 within ``TRAIN_GRAD_TOL``.  lm20m
  whole preempted at step 6 (``PreemptionGuard.request_stop``), restored
  and finished: params, moments and loss tail bit-identical to an
  uninterrupted run.  mamba2-1.3b at full width, 16 of 48 layers
  (``TRAIN_MAMBA2_LAYERS``; remat full), global batch 8 in 2 blocks of 512 tokens, so that the
  chunked SSD route carries the gradient: 3 ``spliter`` steps at peak lr
  1e-4, loss and every gradient finite; then, as a witness for a step at
  peak lr 1e-3, mamba2-1.3b cut to 2 layers at full width in f32: step 1's
  gradients and 3 steps' losses (one sequence of 512 a step; the second
  step at the peak, the third's loss after it) on the card against the CPU
  port's from the same params.  Every ``ARCH_IDS`` smoke config: one f32
  ``spliter`` step's loss and gradients on the card against the same step
  on the CPU from the same params, gates at 0.75.  Checks of the repair:
  ``ops.flash_attention`` and ``ops.ssd_scan`` raise on an operand that
  requires a gradient, and neither kernel launches in the whole phase (the
  model takes the plain attention and SSD under autograd).  The kernels
  line gives ``train_launches`` (0 for every kernel).
* ``distributed``: the distribution substrate (``repro_torch.distributed``,
  ``launch/mesh.py``), every rank a position on the card.  ``rank_threads``
  times 400 small operations launched by one thread, by 8 threads at once
  and by 8 ``shard_map`` ranks in turn, and an empty 8-rank call against
  starting 8 threads.  ``sharded_train``: lm100m whole, one
  ``sharded_train_step`` on a (2, 2, 2) ``(pod, data, model)`` mesh (params
  placed by ``params_shardings``, data-parallel over ``(pod, data)``)
  against the unsharded step, loss within 5e-3, the gradient gap printed.
  ``collectives``: its f32 gradient tree through ``psum_pod_hierarchical``
  and a flat ``psum`` on (2, 4) ``(pod, data)``: within 1e-6 of each other
  and 1e-5 of 8× the input, two runs bit-identical, GB/s beside a clone's;
  ``compressed_psum_pod`` on the largest leaf within the int8 bound.
  ``elastic_restore``: params and AdamW moments saved from an (8,)
  placement, restored onto (2,), bit-equal.  ``gpipe``: the 12 layers as 4
  stages of 3 on (4, 2) ``(pipe, data)``, 8 microbatches of 8 × 1024 bf16
  hidden states, against the layers in order (``BF16_TOL``), the flash
  kernel launched 8 ranks × 11 ticks × 3 layers = 264 times.  Decode:
  qwen3-32b at the serve row's depth, 64 steps, under ``"decomposed"``
  (bf16 and f32, against the default path) and ``"sharded_dus"`` on (2, 4) ``(data,
  model)``; deepseek-7b (2 layers) under ``decode_rules_headsharded`` and
  deepseek-v2-236b (2 layers) under ``"sharded_dus"``, 16 steps: logits and
  caches bit-equal to the default path; ms per step beside it.  The kernels
  line gives ``distributed_launches``.
* ``tensor_parallel``: the serving path split over ``model``
  (``repro_torch.distributed.sharded_prefill`` / ``sharded_decode_step``),
  every rank a position on the card, at full width (bf16, flash, random
  weights from the seed) on (1, 4) and (1, 16) ``(data, model)`` meshes,
  the second the production model axis (``TP_RUNS``): qwen3-32b at 8 and 2
  layers (its 8 kv heads whole at 16), mamba2-1.3b at 8 and 4 of 48
  layers (its 64 SSM heads 16 and 4 a rank), jamba-v0.1-52b's first period (7
  mamba2 layers, one attention layer, 4 MoE layers of 16 experts: 4 and 1
  a rank) and mixtral-8x7b at 2 layers (16 virtual experts).  Per mesh the
  unsharded model runs first in bf16 and on the same weights upcast to f32,
  then its params are placed leaf by leaf, freeing each whole leaf (one
  copy on the card).  The tensor-parallel f32 runs, the prefill of 8
  512-token prompts and ``TP_F32_STEPS`` decode steps under
  ``decode_rules`` (the cache's sequence over model, context-parallel
  decode) and ``decode_rules_headsharded`` (``"heads_dus"``), fed the
  unsharded model's greedy tokens, hold every config: logits within
  ``F32_LOGIT_TOL`` of the unsharded f32 run, its cache within it
  relatively, and the MoE routes the unsharded f32 run's but at most
  ``F32_ROUTE_FLIPS`` (layer, token) pairs.  Then the bf16 runs under both
  rule sets, 4 greedy steps (2 for the SSM, MoE, MLA and cross-attention
  configs at (1, 16), whose f32 runs take 2 too):
  for the dense config the logits and the cache within ``TP_BF16_TOL`` of
  the unsharded model on the same weights and the greedy tokens equal
  wherever the unsharded top-2 margin exceeds it; with SSM or MoE layers
  the bf16 errors are printed, not judged (the unsharded bf16 model is
  itself about as far from its f32 run as the logits are large).  In every
  bf16 run the flash and
  SSD kernels launched ranks × attention and mamba2 layers a prefill, a
  rank's parameter bytes equal to the closed form
  (``_tp_rank_param_bytes``); the prefill's peak memory rise and the
  prefill and decode times beside the unsharded ones, printed, not judged
  (the ranks take turns on one card).  The flash and ``ssd_scan`` entries
  of the kernels line give ``tensor_parallel_cases``, each kernel at the
  ranks' shapes (``TP_FLASH_SHAPES``, ``TP_SSD_SHAPES``) beside its plain
  version, and every entry ``tensor_parallel_launches``.
* ``long_decode``: a batch of one at long context under
  ``long_decode_rules`` (the cache's rows over ``data``, every kv head on
  each rank; the heads over ``model``), ``sharded_prefill`` /
  ``sharded_decode_step`` on a (2, 4) ``(data, model)`` mesh of positions
  on the card, at full width with a cache of ``LD_MAX_LEN`` = 524,288
  rows, the ``long_500k`` cell's (``LD_RUNS``): mamba2-1.3b at 8 of 48
  layers and jamba-v0.1-52b's first period with 4,096-token prompts,
  mixtral-8x7b at 2 layers with 8,192 (twice its 4,096-slot ring, which
  the prompt wraps).
  The unsharded model runs in bf16 (8 greedy steps), then on the same
  weights upcast to f32 (4 steps fed the bf16 run's tokens, then one step
  at slot 524,287, the dry-run's, over seeded rows: the attention rows no
  run wrote, all of mixtral's ring); the long-context f32 run does the same
  on the params placed leaf by leaf and is held to it: logits within
  ``F32_LOGIT_TOL`` where the MoE routes agree, every rank's cache block
  within it relatively, the routes apart at no more than
  ``F32_ROUTE_FLIPS`` near-ties (``ROUTE_NEAR_TIE``; the first flip at one,
  the rows from it on and the SSM state then not held).  The bf16 run
  prints its errors beside the unsharded model's (SSM and MoE configs, as
  in ``tensor_parallel``), the flash and SSD kernels launched ranks ×
  layers in its prefill, a rank's cache bytes against the closed form
  (``_long_cache_bytes``: half the rows), a rank's parameter bytes, the
  prefill's peak memory rise, prefill and decode times beside the
  unsharded model's, and the collectives of one decode step.  The data
  ranks' copies of a weight block and the model ranks' copies of a k/v
  block share one tensor on the card (each card of a real mesh holds one).
  The flash and ``ssd_scan`` entries of the kernels line give
  ``long_decode_cases`` (``LD_FLASH_SHAPES``, ``LD_SSD_SHAPES``), every
  entry ``long_decode_launches``.
* ``tp_train``: the train step tensor-parallel over ``model`` under
  ``train_rules`` (``sharded_train_step(..., rules=train_rules(mesh))``)
  and ``train_rules_sp``,
  every rank a position on the card, TF32 off, within its own limit
  (``TP_TRAIN_TIMEOUT_S``: past it the script exits non-zero, so a
  deadlock in a backward fails the run).  First a two-rank ``pvary`` /
  ``psum`` backward through the collectives' autograd nodes (the card's
  autograd thread runs it, not the rank's: each rank's node raises, no
  hang) and through ``value_and_grad``'s backward in segments (the exact
  gradient).  Then lm100m whole in f32 on (2, 2, 2) ``(pod, data, model)``
  and (1, 4), two steps (three until the SSM, hybrid and MoE rows came)
  of 2 blocks of 8 × 1024 (``TP_TRAIN_LM_BLOCKS``, 4 until then) from one
  seeded init, beside the unsharded
  step: each step's loss within ``TP_TRAIN_LOSS_RTOL`` and gradients
  (``tensor_parallel_gradients``) within ``TP_TRAIN_TREE_TOL`` of each
  leaf's maximum, and after the last both moments within it and every
  param within 2·lr; the params keep their layouts.  qwen3-32b at full
  width (1 layer, ``TP_TRAIN_QWEN3``: at 2 layers the f32 unsharded and
  sharded gradients and params on one card ran out of its 80 GB) on
  (1, 4): the loss and gradients the same, then one step with the
  unsharded params freed.  Each line prints the step's ms beside the
  unsharded gradients' (and lm100m's beside the data-parallel step's), the
  census of a step, a rank's parameter and moment bytes and the step's
  peak memory rise; lm100m in bf16 on (1, 4) prints its loss and gradient
  errors.  Then the SSM, MoE and hybrid rows (``_tp_train_families``):
  mamba2-1.3b at full width, 8 of 48 layers, on (1, 4) and mixtral-8x7b
  at full width, 1 layer, on (1, 4) and (2, 2) (a rank's 512 tokens half
  a 1,024-token group, so the token rows are all-gathered over data), 2
  steps of 2 blocks of 2 × 512 (mixtral one), each step held to the
  unsharded step from
  the sharded run's own params and moments (``_tp_train_forced``: the
  loss, gradients, moments and params as above, where the MoE routes of
  the two agree; every route that flips must sit at a near-tie of the
  unsharded router, ``ROUTE_NEAR_TIE``); jamba's period at its smoke width
  on (2, 2, 2) (a cut: 13.3 B params at full width) the same way; and
  mixtral's data-parallel step at smoke width on (2, 2, 2) (a cut: that
  program holds every param whole on each rank), whose MoE ranks gather
  the batch's token rows and run their backward in segments, against
  the unsharded step.  Then the MLA, vision and audio rows
  (``_tp_train_memory_families``), held the same way, every cross
  ``gate`` at ``TP_TRAIN_GATE`` (drawn 0, it would zero every gradient of
  the cross layers and the encoder; each row checks them nonzero):
  deepseek-v2-236b's first layer at full width on (1, 4) (MLA and the
  dense SwiGLU; a cut: its second layer is a 160-expert MoE) and its three
  smoke layers on (2, 2, 2) (a width cut); llama-3.2-vision-11b's first
  period (5 of 40 layers, the cross layer's kv heads split) at full width
  on (1, 4), its ``image_embeds`` seeded; whisper-tiny whole, its
  ``frames`` seeded, on (2, 2) and on (1, 4), where its 6 heads do not
  divide the axis and each rank computes attention whole.  Then the
  sequence-parallel rows (``_tp_train_sequence_parallel``, ``TP_TRAIN_SP``:
  ``train_rules_sp``, the residual stream between blocks split by sequence
  over ``model``), held the same way, each followed by one ``train_rules``
  step from its last state whose ms, peak memory rise and census print
  beside its own: qwen3-32b (1 layer), mixtral-8x7b (1 layer) and
  mamba2-1.3b (2 layers) at full width and whisper-tiny whole on (1, 4)
  (its 1,500 frames 375 a rank, attention whole on every rank's gathered
  rows), deepseek-v2's and the vlm's smoke configs on (2, 2, 2).  No
  kernel runs (none has a backward): every entry of the kernels line gives
  ``tp_train_launches`` 0.
* ``dryrun``: the shape-only dry-run (``repro_torch.launch.dryrun_lib``)
  held against the card.  qwen3-32b's prefill as the serve phase runs it
  (4 layers, 8 × 512 tokens, flash, bf16) and the train phase's lm100m
  ``spliter`` step (gradients and the AdamW update) are each counted by
  ``count_cost`` on ``meta`` and on ``cuda:0``: FLOPs, bytes and the
  kernels' formulas equal, the prefill's flash kernel launched once a
  layer with its formula in the count.  Each step's time is the median of
  3 warm runs between CUDA events; the H100 SXM compute term of its count
  must not exceed it (the memory term and the roofline fraction are
  printed).  The dry-run's ``argument_bytes`` for the prefill's params
  (bf16, as it lays them out), cache and tokens on a one-position mesh
  must be within 1 % of the rise of ``torch.cuda.memory_allocated`` after
  placing them.  ``run_matrix`` and ``run_probe_matrix`` (the depth fit)
  over every ``ARCH_IDS`` × ``SHAPES`` cell of both production meshes run
  in spawned worker processes beside those checks: no FAIL, every SKIP
  ``cell_skip_reason``'s.  ``wrapper_host_ms`` gives the flash and SSD
  wrappers' ``host_ms`` at the kernels line's shapes, three rounds each
  with no cost sink and with one open.  The phase prints its seconds (41–45
  s on an H100's host).  The kernels line's ``dryrun_launches`` are the two
  counted runs' launches; the ``launches`` line adds the phase's total
  (the timed runs and the wrapper timing too).

Output: the card's name and power limit (``nvidia-smi``) on the first line,
the compiler's registers, stack, spills and shared memory per kernel (a
``ptxas`` line), one JSON line per run and check, a ``{"kernels": [...]}``
line, and as the last line ``{"ok": true, "device": {...}}``.  Any failed check raises and
the script exits non-zero; it also exits non-zero, printing no result,
when no CUDA device is present or the repository's ``src`` is missing.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, f32 outside the tensor
# cores, dense bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12

LOCATIONS, BLOCKS_PER_LOCATION, BLOCK_ROWS = 8, 16, 262_144
HIST_D, HIST_BINS = 5, 8
KM_D, KM_K, KM_ITERS, KM_SIGMA = 20, 8, 10, 0.02
VALUE_BINS = 128

# serving: per run, the arch, its config overrides, the kernel its prefill
# launches once per layer, and the bf16 logit tolerance.  bf16 logits computed
# by two algorithms (prefill vs the token-by-token recurrence, flash vs ref
# attention) differ by rounding that random-weight layers amplify with depth;
# each serve line reports the yardstick, the reference's own bf16 recurrence
# against the same recurrence in f32 ("bf16_recurrence_vs_f32_recurrence"),
# and each tolerance is two to three times what it measured on an H100 (700
# W) at the row's depth: 0.074 for qwen3-32b at 4 layers, 0.185 for
# mamba2-1.3b at 8.  A third run holds mamba2's bf16 route at 2 layers of
# the same width, where the yardstick is smaller still.  "depth_check" runs stay out of the kernel
# line's launch counts, which come from the deeper runs.  The three dense
# configs whose layer branches qwen3 does not take (qwen2's QKV bias,
# command-r's parallel block, layernorm and tied embeddings, deepseek's MHA)
# run at full width cut to 1 layer, 8 decode steps; their yardsticks
# measured 0.054, 0.031 and 0.057, hence 0.15.
#: The serve rows' depths are cut for the script's time limit: the
#: token-by-token recurrence that checks a row runs every layer about a
#: thousand times (bf16 and f32) on the host's clock.  qwen3-32b 4 of 64
#: layers, mamba2-1.3b 8 of 48, the dense branch rows 1 layer.
SERVE_QWEN3_LAYERS, SERVE_MAMBA2_LAYERS, SERVE_BRANCH_LAYERS = 4, 8, 1
SERVE = {
    "qwen3-32b": {"arch": "qwen3-32b",
                  "overrides": {"num_layers": SERVE_QWEN3_LAYERS, "attn_impl": "flash"},
                  "kernel": "flash_attention", "logit_tol": 0.25},
    "mamba2-1.3b": {"arch": "mamba2-1.3b", "overrides": {"num_layers": SERVE_MAMBA2_LAYERS},
                    "kernel": "ssd_scan", "logit_tol": 0.5},
    "mamba2-1.3b/2-layers": {"arch": "mamba2-1.3b", "overrides": {"num_layers": 2},
                             "kernel": "ssd_scan", "logit_tol": 0.25, "depth_check": True},
    **{arch: {"arch": arch, "overrides": {"num_layers": SERVE_BRANCH_LAYERS, "attn_impl": "flash"},
              "kernel": "flash_attention", "logit_tol": 0.15, "steps": 8, "depth_check": True}
       for arch in ("qwen2-72b", "command-r-35b", "deepseek-7b")},
}
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX_LEN = 8, 512, 32, 576
#: the MoE configs at full width, depth cut (mixtral 1 of 32 layers, for
#: the script's time limit; jamba one period of 8 of 32, deepseek-v2 its dense first layer and one MoE
#: layer of 60), 8 decode steps.  The dropless row runs at capacity factor
#: E/k (no group drops a token, so the prefill and the recurrence compute
#: one function), the published row at the config's 1.25 on the same
#: weights.  Mixtral and jamba attend with the flash kernel; deepseek-v2's
#: MLA attends with its own products.  The bf16 logit tolerance is two to
#: three times the yardstick ("bf16_recurrence_vs_f32_recurrence", at the
#: positions where the two recurrences route alike) measured on an H100
#: (700 W): 0.072 for mixtral at 1 layer, 1.05 for jamba (a route flip at
#: an earlier position changes the SSM state every later position reads),
#: 0.077 for deepseek-v2.
MOE_SERVE = {
    "mixtral-8x7b": {"layers": 1, "flash": True, "logit_tol": 0.2},
    "jamba-v0.1-52b": {"layers": 8, "flash": True, "logit_tol": 2.5},
    "deepseek-v2-236b": {"layers": 2, "flash": False, "logit_tol": 0.2},
}
MOE_STEPS = 8
#: the cross-attention configs at full width through ``Server.generate`` with
#: ``extras``, batch 8, 512-token prompts, 8 decode steps, attn_impl "flash":
#: whisper-tiny whole (4 encoder and 4 decoder layers; memory: the encoder's
#: output over 1500 frames of 384) and llama-3.2-vision-11b cut to two
#: periods (10 of 40 layers: 8 self- and 2 cross-attention layers, so that
#: the cross cache is stacked over the repeats; memory: 1600 image tokens of
#: 4096, passed again at every decode step as the reference's server does).
#: Every cross layer's gate is set to CROSS_GATE after ``Model.init``: the
#: reference draws it 0, and tanh(0) would hide the whole cross path.  The
#: image embeddings are normal rows plus one shared normal row per image (the
#: patch embeddings of one image share a part): over 1600 independent rows
#: attention averages the memory to about 0, and the prefill with every gate
#: at 0 then moved the logits by only 0.197 on an H100, below the tolerance,
#: so the check could not tell a memory that reaches the logits from one
#: that does not (with the shared row: 3.53).  The encoder's output,
#: whisper's memory, has such a part of its own (4.63).  The bf16 logit
#: tolerance is two to three times the yardstick
#: ("bf16_recurrence_vs_f32_recurrence") measured on an H100 (700 W): 0.079
#: for whisper-tiny, 0.070 for llama-3.2-vision-11b.
CROSS_SERVE = {
    "whisper-tiny": {"overrides": {}, "logit_tol": 0.2},
    "llama-3.2-vision-11b": {"overrides": {"num_layers": 10}, "logit_tol": 0.2},
}
CROSS_STEPS = 8
CROSS_GATE = 1.0
#: the flash kernel at the encoder's and cross-attention's shapes (not
#: causal; Lk 1500 and 1600 are not multiples of the kernel's 128-row
#: tiles): label -> (Lq, Lk, H, Hkv, D), batch 8
CROSS_FLASH_SHAPES = {
    "whisper_encoder": (1500, 1500, 6, 6, 64),
    "whisper_cross": (512, 1500, 6, 6, 64),
    "vlm_cross": (512, 1600, 32, 8, 128),
}
#: in bf16 a near-tie of router probabilities sends a token to another
#: expert in the prefill than in the recurrence (an O(1) change of its
#: output); such positions are printed and left out of the bf16 logit
#: checks, and may be at most this share of the compared positions
ROUTE_FLIP_SHARE = 0.25
#: the moe phase: 4096 tokens (groups of 1024) tilted by MOE_SKEW times one
#: shared random row, and MOE_DECODE_GROUPS decode-sized groups of 8
MOE_TOKENS, MOE_SKEW, MOE_DECODE_GROUPS = 4096, 1.0, 8
#: the prefill and the recurrence in f32 on the same weights: only float
#: reassociation separates them
F32_LOGIT_TOL = 1e-3
#: a bf16 kernel output (flash attention; ssd_scan on bf16 inputs) against its
#: plain version: the tests' bf16 tolerance (tests/test_kernels.py TOL), about
#: five bf16 steps of each value plus the rounding of a value of 10
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
#: ssd_scan in f32 against its plain version (tests/test_kernels.py:173)
SSD_TOL = dict(rtol=3e-4, atol=3e-4)
#: an f32 kernel output (flash attention's split route) against its plain
#: version: the reference tests' f32 tolerance (tests/test_kernels.py TOL)
F32_TOL = dict(rtol=2e-5, atol=2e-5)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


class PhaseClock:
    """Each phase's wall seconds and the garbage collector's seconds in it
    (``gc.callbacks``).  Calling it runs a phase: ``clock(name, fn, *args)``
    returns ``fn(*args)`` and prints the phase's seconds, the collector's
    and the script's so far as it ends (so a run cut at its time limit shows
    how far it got).  The objects alive before the phase are frozen out of
    the cyclic collector while it runs (``gc.freeze``), so that a collection
    scans only what the phase made: the phases call ``gc.collect()``
    hundreds of times to hand memory back to the card, and one over the
    whole heap (torch's modules included) is slow."""

    def __init__(self) -> None:
        self.start = time.perf_counter()
        self.seconds: dict[str, float] = {}  # in the order the phases ran
        self.gc_seconds = 0.0
        self._gc_start = 0.0
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._gc_start = time.perf_counter()
        else:
            self.gc_seconds += time.perf_counter() - self._gc_start

    def __call__(self, name: str, fn, *args):
        gc.collect()
        gc.freeze()
        t0, gc0 = time.perf_counter(), self.gc_seconds
        try:
            out = fn(*args)
        finally:
            gc.unfreeze()
        self.seconds[name] = self.seconds.get(name, 0.0) + time.perf_counter() - t0
        emit({"phase": "clock", "after": name, "seconds": self.seconds[name],
              "gc_seconds": self.gc_seconds - gc0,
              "since_start": time.perf_counter() - self.start})
        return out


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median time of ``fn`` on the current stream, CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_and_host_ms(fn, reps: int = 20) -> tuple[float, float]:
    """``(device ms, host ms)`` per call of ``fn``.  The calls are queued
    behind a sleeping kernel, so the card runs them back to back: CUDA events
    around them give the card's time per call without the host's launch work,
    and the host clock around the queueing gives that work.  Median of 3."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    reps = max(3, min(reps, int(0.2 / max(once, 1e-6))))
    device, host = [], []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(3 * reps * once * 2e9) + 1_000_000)  # cycles, at ~2 GHz
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host.append((time.perf_counter() - t0) / reps * 1e3)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / reps)
    return statistics.median(device), statistics.median(host)


def kernel_times(fn) -> dict:
    """``ms`` (``cuda_ms``), and ``device_ms`` and ``host_ms``
    (``device_and_host_ms``)."""
    device_ms, host_ms = device_and_host_ms(fn)
    return {"ms": cuda_ms(fn), "device_ms": device_ms, "host_ms": host_ms}


def bound(nbytes: int, flops: int, peak: float = F32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work on an H100 SXM, and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _kernel_name(mangled: str) -> str:
    """``flash_kernel<128>``, ``ssd_kernel<bf16>`` ... from a mangled name."""
    m = re.search(r"_cu_[0-9a-f]{8}(\d+)(\w+)", mangled)
    if not m:
        return mangled
    n, rest = int(m.group(1)), m.group(2)
    name, tail = rest[:n], rest[n:]
    t = re.match(r"ILi(\d+)EE", tail)
    if t:
        return f"{name}<{t.group(1)}>"
    t = re.match(r"I(f|13__nv_bfloat16)Li(\d+)EE", tail)
    if t:
        return f"{name}<{'f32' if t.group(1) == 'f' else 'bf16'},{t.group(2)}>"
    for code, short in (("I13__nv_bfloat16EE", "bf16"), ("IfEE", "f32")):
        if tail.startswith(code):
            return f"{name}<{short}>"
    return name


def ptxas_line(reports: dict) -> list[dict]:
    """Registers, stack, spills and shared memory per kernel, from the
    compiler's ``-Xptxas -v`` reports; dynamic shared memory as each kernel
    requests it at launch on its main path (k-means at d=20, k=8; the value
    histogram at 128 bins; the d-dimensional histogram at d=5, bins=8)."""
    import ctypes

    from repro_torch.kernels import partition_reduce as pr
    from repro_torch.kernels._build import kernel_function

    flash_smem = kernel_function("flash_attention", "repro_flash_attention_smem_bytes",
                                 [ctypes.c_int])
    split_smem = kernel_function("flash_attention", "repro_flash_attention_split_smem_bytes",
                                 [ctypes.c_int, ctypes.c_int])
    ssd_smem = kernel_function("ssd_scan", "repro_ssd_scan_smem_bytes", [ctypes.c_int])
    dynamic = {f"flash_kernel<{d}>": flash_smem(d) for d in (32, 64, 128)}
    # the split route at each padded head dim, and its split kernel (f32)
    dynamic.update({f"flash_split_kernel<{t},{d}>": split_smem(d, int(t == "bf16"))
                    for t in ("f32", "bf16") for d in (32, 64, 128)})
    dynamic["split_kv_kernel"] = 0
    dynamic.update({"ssd_kernel<bf16>": ssd_smem(1), "ssd_kernel<f32>": ssd_smem(0),
                    "kmeans_partial": pr._kmeans_plan(KM_D, KM_K)[0],
                    "hist_kernel": pr._histogram_plan(VALUE_BINS)[1],
                    "histdd_kernel": pr._histdd_plan(HIST_D, HIST_BINS, 0)[4]})
    out = []
    for lib, text in reports.items():
        entry = None
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = {"library": lib, "function": _kernel_name(m.group(1))}
                continue
            if entry is None:
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                entry.update(stack_frame_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                entry["registers"] = int(m.group(1))
                static = re.search(r"(\d+) bytes smem", line)
                entry["static_smem_bytes"] = int(static.group(1)) if static else 0
                entry["dynamic_smem_bytes"] = dynamic.get(entry["function"])
                out.append(entry)
                entry = None
    return out


def make_data(seed: int, dev: torch.device, block_rows: int = BLOCK_ROWS):
    """Uniform histogram rows and k-means blobs, generated on the card.

    The blob means sit near the seed's initial k-means centers (a 0.05
    offset, against ~1.8 between centers), so every row is far from a tie
    and counts compare exactly across policies and formulas.
    """
    from repro_torch.core.apps.kmeans import _init_centers

    n = LOCATIONS * BLOCKS_PER_LOCATION * block_rows
    gen = torch.Generator(device=dev).manual_seed(seed)
    hist = torch.rand((n, HIST_D), generator=gen, device=dev)
    init = _init_centers(seed, KM_K, KM_D, torch.float32, dev)
    means = init + 0.05 * torch.randn((KM_K, KM_D), generator=gen, device=dev)
    labels = torch.randint(0, KM_K, (n,), generator=gen, device=dev)
    km = torch.randn((n, KM_D), generator=gen, device=dev).mul_(KM_SIGMA)
    km.add_(means[labels])
    return hist, km, means, torch.bincount(labels, minlength=KM_K)


def main_path(x_hist, x_km, means, label_counts, seed: int, repeats: int) -> dict:
    """Both apps under every policy through the port's entry points."""
    from repro_torch.api import Baseline, Collection, Rechunk, SplIter, engine
    from repro_torch.core.apps.histogram import histogram
    from repro_torch.core.apps.kmeans import _combine, kmeans, partial_sum_block
    from repro_torch.kernels import partition_reduce as pr

    policies = {
        "baseline": (Baseline(), False),
        "spliter1_scan": (SplIter(1, fusion="scan"), False),
        "spliter1_pallas": (SplIter(1, fusion="pallas"), True),
        "spliter2_auto": (SplIter(2), True),
        "rechunk": (Rechunk(), False),
    }
    pr.partition_histogramdd.launches = 0
    pr.partition_kmeans.launches = 0
    hists, centers, counts, per_call = {}, {}, {}, {}
    partition_bytes = BLOCKS_PER_LOCATION * BLOCK_ROWS * HIST_D * 4
    for name, (pol, kernel_path) in policies.items():
        with engine("local") as ex:
            h0, k0 = pr.partition_histogramdd.launches, pr.partition_kmeans.launches
            runs = []
            for i in range(1 + repeats):  # one warm-up, then timed runs
                if i == repeats:  # the last run: how far device memory rises
                    gc.collect()  # earlier passes' cycles (see _peak_rise)
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                h, rep = histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex)
                runs.append(rep)
            torch.cuda.synchronize()
            peak_rise = torch.cuda.max_memory_allocated() - base
            hists[name] = h
            emit({"phase": "main_path", "app": "histogram", "policy": name,
                  "dispatches": rep.dispatches, "traces": runs[0].traces,
                  "bytes_moved": runs[0].bytes_moved,
                  "wall_s": statistics.median(r.wall_s for r in runs[1:]),
                  "peak_memory_rise": peak_rise,
                  "launches": pr.partition_histogramdd.launches - h0})
            check((pr.partition_histogramdd.launches > h0) == kernel_path,
                  f"histogram/{name} kernel routing")
            if name == "spliter1_pallas":
                per_call["partition_histogramdd"] = (
                    (pr.partition_histogramdd.launches - h0) / len(runs), "SplIter(1, pallas) histogram pass")
                check(peak_rise < partition_bytes,
                      f"a SplIter(1, pallas) histogram pass copies no partition: peak memory "
                      f"rose {peak_rise} B, a partition is {partition_bytes} B")
            walls, results = [], []
            for _ in range(1 + repeats):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = kmeans(x_km, k=KM_K, iters=KM_ITERS, seed=seed, policy=pol, executor=ex)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                results.append(res)
            km_runs = pr.partition_kmeans.launches - k0
            centers[name] = res.centers
            counts[name] = (
                Collection.from_blocked(x_km).split(pol)
                .map_blocks(partial_sum_block, extra_args=(res.centers,))
                .reduce(_combine).compute(executor=ex).value[1]
            )
            emit({"phase": "main_path", "app": "kmeans", "policy": name,
                  "iterations": KM_ITERS, "dispatches": res.total_dispatches,
                  "traces": sum(r.traces for r in results[0].reports),
                  "bytes_moved": results[0].total_bytes_moved,
                  "wall_s": statistics.median(walls[1:]),
                  "report_wall_s": statistics.median(r.total_wall_s for r in results[1:]),
                  "launches": pr.partition_kmeans.launches - k0})
            check((pr.partition_kmeans.launches > k0) == kernel_path,
                  f"kmeans/{name} kernel routing")
            if name == "spliter1_pallas":
                per_call["partition_kmeans"] = (
                    km_runs / len(walls),
                    f"SplIter(1, pallas) k-means run of {KM_ITERS} iterations")
    launches = {"partition_histogramdd": pr.partition_histogramdd.launches,
                "partition_kmeans": pr.partition_kmeans.launches}

    n = x_hist.num_rows
    ref_h = hists["baseline"]
    for name, h in hists.items():
        check(torch.equal(h, ref_h), f"histogram {name} equals baseline")
    check(int(ref_h.sum()) == n, "histogram total equals the row count")
    ref_c, ref_n = centers["baseline"], counts["baseline"]
    for name in centers:
        check(torch.equal(counts[name], ref_n), f"kmeans counts {name} equal baseline")
        check(torch.allclose(centers[name], ref_c, rtol=1e-4, atol=1e-6),
              f"kmeans centers {name} within 1e-4 of baseline")
    check(torch.equal(ref_n, label_counts.to(ref_n.dtype)), "kmeans counts equal blob sizes")
    # each center is its blob's sample mean: off by ~sigma/sqrt(size) per coordinate
    err = float((ref_c - means).abs().max())
    limit = 6 * KM_SIGMA / float(label_counts.min()) ** 0.5
    check(err < limit, f"kmeans centers recover the blob means ({err} >= {limit})")
    emit({"phase": "agreement", "policies": list(policies), "histogram_total": int(ref_h.sum()),
          "kmeans_counts": ref_n.tolist(), "kmeans_max_center_error": err})
    return launches, per_call


def kernel_checks(x_hist, x_km, seed: int, launches: dict, per_call: dict) -> list[dict]:
    """Each kernel at the main path's per-task shape, against its plain version."""
    from repro_torch.core.apps.kmeans import _init_centers
    from repro_torch.kernels import partition_reduce as pr

    out = []
    ids = x_hist.blocks_at(0)
    blocks = [x_hist.block(b) for b in ids]  # the partition's blocks, where they lie
    st = torch.stack(blocks)
    stack_ms = cuda_ms(lambda: torch.stack(blocks))
    nb, rows, d = st.shape
    got = pr.partition_histogramdd(blocks, bins=HIST_BINS)
    want = pr.partition_histogramdd_ref(blocks, bins=HIST_BINS)
    check(torch.equal(got, want), "partition_histogramdd equals its plain version")
    check(torch.equal(pr.partition_histogramdd(blocks, bins=HIST_BINS), got),
          "partition_histogramdd gives the same bits on a second launch")
    check(torch.equal(pr.partition_histogramdd(st, bins=HIST_BINS), want),
          "partition_histogramdd on the stacked blocks equals its plain version")
    big = pr.partition_histogramdd(blocks, bins=16)  # 2**20 cells: counts in global memory
    check(torch.equal(big, pr.partition_histogramdd_ref(blocks, bins=16)),
          "partition_histogramdd (2**20 cells) equals its plain version")
    times = kernel_times(lambda: pr.partition_histogramdd(blocks, bins=HIST_BINS))
    plain_ms = cuda_ms(lambda: pr.partition_histogramdd_ref(blocks, bins=HIST_BINS))
    big_ms = cuda_ms(lambda: pr.partition_histogramdd(blocks, bins=16))
    big_device_ms, _ = device_and_host_ms(lambda: pr.partition_histogramdd(blocks, bins=16))
    cluster, slice_log2, tile_rows, stage_bytes, smem, grid = pr._histdd_plan(d, HIST_BINS, 0)
    # the one PyTorch call for a d-dim histogram, tried on the card's rows
    flat = st.reshape(-1, d)
    try:
        library = {"call": "torch.histogramdd", "ms": cuda_ms(
            lambda: torch.histogramdd(flat, bins=HIST_BINS, range=[0.0, 1.0] * d))}
    except (RuntimeError, NotImplementedError) as err:
        library = {"call": "torch.histogramdd", "error": f"{type(err).__name__}: {err}"[:400]}
    del flat
    # per value a subtract and a multiply, per row one index multiply-add per value
    bound_ms, bound_by = bound(st.numel() * 4 + HIST_BINS**d * 4, 3 * st.numel())
    out.append({
        "name": "partition_histogramdd", "route": "cuda",
        "source": "src/repro_torch/csrc/partition_histogramdd.cu",
        "replaces": "src/repro/kernels/partition_reduce.py:146",
        "launches": launches["partition_histogramdd"],
        "launches_per_call": per_call["partition_histogramdd"][0],
        "per_call_of": per_call["partition_histogramdd"][1],
        "max_abs_err": int((got - want).abs().max()), "tolerance": "bit-exact",
        **times, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library.get("ms"), "library": library,
        "shape": [nb, rows, d], "bins": HIST_BINS, "in_place": True,
        "stack_ms": stack_ms,
        "design": {
            "reads": f"the {nb} blocks in place, by pointer; {tile_rows}-row tiles by bulk "
                     f"copy into a ring of {pr._HISTDD_STAGES} stages per CTA",
            "binning": "(x - lo) * C with C = f32(f32(1 / (hi - lo)) * bins), as XLA folds "
                       "the reference's division; clamp in float, truncate",
            "merge": f"clusters of {cluster} CTAs share one histogram in distributed shared "
                     f"memory ({1 << slice_log2} cells a CTA); one global atomic per "
                     f"non-zero cell per cluster",
            "grid": grid, "dynamic_smem_bytes": smem,
        },
        "ms_2pow20_cells": big_ms, "device_ms_2pow20_cells": big_device_ms,
    })

    ids = x_km.blocks_at(0)
    blocks = [x_km.block(b) for b in ids]
    st = torch.stack(blocks)
    stack_ms = cuda_ms(lambda: torch.stack(blocks))
    nb, rows, d = st.shape
    c = _init_centers(seed, KM_K, KM_D, torch.float32, st.device)
    sums, cnt = pr.partition_kmeans(st, c)
    sums2, cnt2 = pr.partition_kmeans(st, c)
    rsums, rcnt = pr.partition_kmeans_ref(st, c)
    check(torch.equal(cnt, rcnt), "partition_kmeans counts equal its plain version")
    check(torch.allclose(sums, rsums, rtol=1e-4, atol=1e-3),
          "partition_kmeans sums within 1e-4 of its plain version")
    check(torch.equal(sums, sums2) and torch.equal(cnt, cnt2),
          "partition_kmeans gives the same bits on a second launch")
    smem, per_sm = pr._kmeans_plan(d, KM_K)
    x64, c64 = st.reshape(-1, d).double(), c.double()
    d2 = torch.sort((c64 * c64).sum(1)[None, :] - 2.0 * x64 @ c64.T, dim=1).values
    near_ties = int(((d2[:, 1] - d2[:, 0]) <= 1e-4).sum())
    check(near_ties == 0, f"no float64 near-tie rows ({near_ties})")
    del x64, d2
    times = kernel_times(lambda: pr.partition_kmeans(st, c))
    plain_ms = cuda_ms(lambda: pr.partition_kmeans_ref(st, c))
    n = nb * rows
    bound_ms, bound_by = bound(
        st.numel() * 4 + 2 * KM_K * d * 4 + KM_K * 4, n * KM_K * (2 * d + 1) + n * d
    )
    out.append({
        "name": "partition_kmeans", "route": "cuda",
        "source": "src/repro_torch/csrc/partition_kmeans.cu",
        "replaces": "src/repro/kernels/partition_reduce.py:211",
        "launches": launches["partition_kmeans"],
        "launches_per_call": per_call["partition_kmeans"][0],
        "per_call_of": per_call["partition_kmeans"][1],
        "max_abs_err": float((sums - rsums).abs().max()),
        "max_rel_err": float(((sums - rsums).abs() / rsums.abs().clamp_min(1.0)).max()),
        "tolerance": "counts exact, sums rtol 1e-4, atol 1e-3; bit-identical across launches",
        **times, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "library": "none: no single PyTorch call computes it",
        "shape": [nb, rows, d], "k": KM_K, "near_tie_rows": near_ties, "stack_ms": stack_ms,
        "dynamic_smem_bytes": smem, "ctas_per_sm": per_sm,
    })
    return out


def kernel_counters():
    """The launch counters of every wrapper, by kernel name."""
    from repro_torch.kernels import flash_attention, partition_reduce, ssd_scan

    return {
        "partition_histogram": partition_reduce.partition_histogram,
        "partition_histogramdd": partition_reduce.partition_histogramdd,
        "partition_kmeans": partition_reduce.partition_kmeans,
        "flash_attention": flash_attention.flash_attention,
        "ssd_scan": ssd_scan.ssd_scan,
    }


def reset_launches() -> None:
    from repro_torch.kernels import flash_attention

    for fn in kernel_counters().values():
        fn.launches = 0
    flash_attention.flash_attention.split_launches = 0
    flash_attention.split_kv.launches = 0


def split_launches() -> tuple[int, int]:
    """Launches of the flash kernel's split route (f32; bf16 at other head
    dims) and of its split kernel."""
    from repro_torch.kernels import flash_attention

    return flash_attention.flash_attention.split_launches, flash_attention.split_kv.launches


def read_launches() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def value_histogram_phase(x_hist) -> int:
    """``ops.partition_histogram`` over every location's stacked partition."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import histogram_ref

    reset_launches()
    t0 = time.perf_counter()
    total = None
    for loc in range(LOCATIONS):
        st = torch.stack([x_hist.block(b) for b in x_hist.blocks_at(loc)])
        h = ops.partition_histogram(st, bins=VALUE_BINS, lo=0.0, hi=1.0)
        total = h if total is None else total + h
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    want = histogram_ref(x_hist.collect(), bins=VALUE_BINS, lo=0.0, hi=1.0)
    emit({"phase": "value_histogram", "bins": VALUE_BINS, "partitions": LOCATIONS,
          "wall_s": wall, "launches": launches["partition_histogram"],
          "total": int(total.sum())})
    check(launches["partition_histogram"] == LOCATIONS, f"one launch per partition: {launches}")
    check(torch.equal(total, want), "value histogram equals histogram_ref bit for bit")
    check(int(total.sum()) == x_hist.num_rows * HIST_D,
          "value histogram total equals the value count")
    return launches["partition_histogram"]


def recurrence_logits(model, params, prompts: torch.Tensor, served: torch.Tensor,
                      memory: torch.Tensor | None = None) -> torch.Tensor:
    """Logits predicting each served token, from the prompt and the served
    tokens fed one at a time through ``decode_step`` from an empty cache;
    ``memory`` (cross-attention's) is handed to every step, which projects
    it into the cache."""
    cache = model.init_cache(SERVE_BATCH, SERVE_MAX_LEN, dtype=getattr(torch, model.cfg.dtype),
                             device=prompts.device)
    seq = torch.cat([prompts, served[:, :-1]], dim=1)
    out = []
    with torch.no_grad():
        for pos in range(seq.shape[1]):
            logits, cache = model.decode_step(params, cache, seq[:, pos:pos + 1], pos, memory)
            if pos >= prompts.shape[1] - 1:
                out.append(logits)
    return torch.stack(out, dim=1)  # (B, steps, Vp)


def f32_reference(cfg, params, prompts: torch.Tensor, extras: dict | None = None):
    """Last-prompt-position logits of the prefill and of the recurrence, both
    in f32 on the same weights (and ``extras``) upcast, the prefill through
    the model's own route (mamba2's SSD kernel in f32; the flash kernel on
    its split route), the recurrence handed the f32 model's cross-attention
    memory.  Also the prefill's ms and its split-route and split-kernel
    launches."""
    import dataclasses

    from repro_torch._pytree import tree_map
    from repro_torch.models import build_model

    model = build_model(dataclasses.replace(cfg, dtype="float32"))
    params32 = tree_map(lambda t: t.float(), params)
    extras32 = {k: t.float() for k, t in (extras or {}).items()}
    cache = model.init_cache(SERVE_BATCH, SERVE_MAX_LEN, dtype=torch.float32, device=prompts.device)
    torch.cuda.synchronize()
    split0, t0 = split_launches(), time.perf_counter()
    with torch.no_grad():
        prefill, _ = model.prefill(params32, {"tokens": prompts, **extras32}, cache)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    split = tuple(n - n0 for n, n0 in zip(split_launches(), split0))
    with torch.no_grad():
        memory = model._memory(params32, extras32)
    rec = recurrence_logits(model, params32, prompts, prompts[:, :1], memory)[:, 0]
    v = cfg.vocab_size
    return prefill[:, :v], rec[:, :v], prefill_ms, split


def layer_counts(cfg) -> dict:
    """How many layers of the config's segments (the encoder's too) take
    each mixer and MLP."""
    counts: dict = {}
    for seg in (*cfg.segments(), *cfg.encoder_segments()):
        for spec in seg.period:
            for part in (spec.mixer, spec.mlp):
                counts[part] = counts.get(part, 0) + seg.repeats
    return counts


def expected_launches(cfg, launches: dict) -> dict:
    """Each LM kernel's launches in one prefill, counted from the segments:
    ``flash_attention`` once per attention layer under ``attn_impl="flash"``
    (causal self-attention, the encoder's and cross-attention),
    ``ssd_scan`` once per Mamba2 layer; the partition kernels none."""
    counts = layer_counts(cfg)
    want = {k: 0 for k in launches}
    attention = sum(counts.get(m, 0) for m in ("attn", "enc_attn", "cross_attn"))
    want["flash_attention"] = attention if cfg.attn_impl == "flash" else 0
    want["ssd_scan"] = counts.get("mamba2", 0)
    return want


def _numel(tree, names=None) -> int:
    """Elements of a params tree's leaves (of the leaves named ``names``)."""
    if isinstance(tree, dict):
        return sum(_numel(v, names) if isinstance(v, (dict, tuple, list))
                   else (v.numel() if names is None or k in names else 0) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(_numel(v, names) for v in tree)
    return tree.numel() if names is None else 0


def memory_tokens(cfg) -> int:
    """Cross-attention's memory per sequence: the encoder's frames or the
    image tokens."""
    return cfg.encoder_seq if cfg.family == "audio" else cfg.image_tokens


def prefill_matmul_bound_ms(cfg, params) -> float:
    """Least time of a prefill's layer products in bf16 on an H100 SXM: two
    operations per parameter and token, over all 4096 prompt tokens for
    every segment's parameters, with an MoE layer's experts counted as a
    token uses them (top-k of E, ``ModelConfig.param_counts()["active"]``);
    over the batch's memory tokens for cross-attention's ``wk_mem`` and
    ``wv_mem``, and over its frames for the encoder's parameters."""
    trunk = sum(_numel(seg) for key, seg in params.items() if key.startswith("seg"))
    mem = sum(_numel(seg, {"wk_mem", "wv_mem"}) for key, seg in params.items()
              if key.startswith("seg"))
    counts = cfg.param_counts()
    active = trunk - mem - (counts["total"] - counts["active"])  # the experts a token skips
    work = active * SERVE_PROMPT
    if mem:
        work += mem * memory_tokens(cfg)
    if "enc_seg0" in params:
        work += _numel(params["enc_seg0"]) * cfg.encoder_seq
    return 1e3 * 2 * work * SERVE_BATCH / BF16_FLOPS_PER_S


def serve_phase(name: str, seed: int, dev: torch.device) -> dict:
    """``Server.generate`` at full width, checked against the recurrence."""
    import dataclasses

    import numpy as np

    from repro_torch._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Server

    spec = SERVE[name]
    arch, kernel, tol = spec["arch"], spec["kernel"], spec["logit_tol"]
    steps = spec.get("steps", SERVE_STEPS)
    full = get_config(arch)
    cfg = dataclasses.replace(full, **spec["overrides"])
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    # least time per phase on an H100 SXM: a decode step reads every weight but
    # the embedding (of which it gathers 8 rows) once; a prefill does at least
    # the layers' matrix products for all 4096 tokens in bf16
    # (a tied head reads the whole embedding as its weight)
    embed = params["embed"]
    gathered = 0 if cfg.tie_embeddings else embed.numel() * embed.element_size()
    decode_bound_ms = 1e3 * (param_bytes - gathered) / HBM_BYTES_PER_S
    prefill_bound_ms = prefill_matmul_bound_ms(cfg, params)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    server = Server(cfg, max_len=SERVE_MAX_LEN, device=dev)
    server.load(params)
    server.generate(prompts, steps=2)  # warm-up: library handles, kernel loads

    reset_launches()
    tokens, stats, logits = server.generate(prompts, steps=steps, return_logits=True)
    launches = read_launches()
    bf16_split = split_launches()
    peak = torch.cuda.max_memory_allocated(dev)

    v = cfg.vocab_size  # past it, the padded vocabulary's logits are -1e30
    served = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    prompt_t = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    lf = logits[:, :steps, :v].float()
    rf = recurrence_logits(model, params, prompt_t, served)[..., :v].float()
    prefill_err = float((lf[:, 0] - rf[:, 0]).abs().max())
    decode_err = float((lf[:, 1:] - rf[:, 1:]).abs().max())
    ref_argmax = rf.argmax(-1)
    mismatch = (ref_argmax != served).nonzero().tolist()
    gaps = [float(rf[b, t, ref_argmax[b, t]] - rf[b, t, served[b, t]]) for b, t in mismatch]
    route_err = None
    if cfg.attn_impl == "flash":
        ref_model = build_model(dataclasses.replace(cfg, attn_impl="ref"))
        cache = ref_model.init_cache(SERVE_BATCH, SERVE_MAX_LEN, dtype=torch.bfloat16, device=dev)
        with torch.no_grad():
            ref_logits, _ = ref_model.prefill(params, {"tokens": prompt_t}, cache)
        route_err = float((ref_logits[:, :v].float() - lf[:, 0]).abs().max())
    prefill32, rec32, f32_prefill_ms, f32_split = f32_reference(cfg, params, prompt_t)
    f32_err = float((prefill32 - rec32).abs().max())
    bf16_self_err = float((rf[:, 0] - rec32).abs().max())
    served_vs_f32 = float((lf[:, 0] - rec32).abs().max())
    del prefill32, rec32
    result = {
        "phase": "serve", "run": name, "arch": arch, "d_model": cfg.d_model,
        "layers": cfg.num_layers,
        "layers_full": full.num_layers, "attn_impl": cfg.attn_impl if cfg.num_heads else None,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "steps": steps,
        "max_len": SERVE_MAX_LEN, "dtype": cfg.dtype,
        "prefill_ms": stats.prefill_s * 1e3, "prefill_matmul_bound_ms": prefill_bound_ms,
        "decode_ms_per_token": stats.decode_s / steps * 1e3,
        "decode_bytes_bound_ms": decode_bound_ms,
        "decode_tokens_per_s": stats.tokens_out / stats.decode_s,
        "tokens_per_s": stats.tokens_out / (stats.prefill_s + stats.decode_s),
        "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / stats.prefill_s,
        "dispatches": stats.dispatches, "launches": launches,
        "max_memory_allocated": peak, "param_bytes": param_bytes,
        "param_count": sum(t.numel() for t in tree_leaves(params)), "init_s": init_s,
        "logit_max_abs": float(lf.abs().max()), "logit_std": float(lf.std()),
        "logit_tol": tol, "prefill_vs_recurrence": prefill_err,
        "decode_vs_recurrence": decode_err, "flash_vs_ref_prefill": route_err,
        "f32_prefill_vs_f32_recurrence": f32_err, "f32_prefill_ms": f32_prefill_ms,
        "f32_prefill_flash_split_launches": f32_split[0],
        "f32_prefill_split_kv_launches": f32_split[1],
        "bf16_recurrence_vs_f32_recurrence": bf16_self_err,
        "prefill_vs_f32_recurrence": served_vs_f32, "argmax_mismatches": len(mismatch),
        "mismatch_gaps": gaps,
    }
    emit(result)
    check(stats.dispatches == 1 + steps, f"{name}: dispatches {stats.dispatches}")
    want = expected_launches(cfg, launches)
    check(launches == want, f"{name}: {kernel} launched once per layer of one prefill: {launches}")
    check(bf16_split == (0, 0), f"{name}: the bf16 prefill takes no split-route flash launch "
          f"({bf16_split})")
    want_split = want["flash_attention"]
    check(f32_split == (want_split, want_split), f"{name}: the f32 prefill launches the flash "
          f"kernel's split route and its split kernel once per layer: {f32_split} != "
          f"{want_split}")
    check(bool(torch.isfinite(lf).all()), f"{name}: every logit is finite")
    check(prefill_err <= tol, f"{name}: prefill vs recurrence {prefill_err} > {tol}")
    check(decode_err <= tol, f"{name}: decode vs recurrence {decode_err} > {tol}")
    if route_err is not None:
        check(route_err <= tol, f"{name}: flash vs ref route {route_err} > {tol}")
    check(f32_err <= F32_LOGIT_TOL, f"{name}: f32 prefill vs f32 recurrence {f32_err}")
    check(all(g <= tol for g in gaps), f"{name}: served tokens are the recurrence's "
          f"argmax except at near-ties: gaps {gaps}")
    return result


def _recording_routes(fn):
    """``fn()`` with ``moe_mlp``'s route recorder on → (its result, the routes)."""
    from repro_torch.models.moe import moe_mlp

    moe_mlp.routes = []
    try:
        out = fn()
        return out, moe_mlp.routes
    finally:
        moe_mlp.routes = None


def _per_layer(routes: list, n_layers: int, key: str = "experts") -> list[torch.Tensor]:
    """Recorded calls (layer after layer, prefill and step after step) → per
    MoE layer, ``(B, positions, k)`` along the positions (experts sorted per
    token: a route is the set a token chose)."""
    out = []
    for layer in range(n_layers):
        calls = [r[key] for r in routes[layer::n_layers]]
        out.append(torch.cat([c.sort(-1).values if key == "experts" else c for c in calls], 1))
    return out


def _route_flips(a: list, b: list) -> torch.Tensor:
    """``(layers, B, P)``: where two runs' routes differ, over the positions
    both recorded."""
    p = min(a[0].shape[1], b[0].shape[1])
    return torch.stack([(x[:, :p] != y[:, :p]).any(-1) for x, y in zip(a, b)])


def _drops(routes: list, n_layers: int) -> tuple[int, list[int]]:
    """Dropped (token, choice) pairs in the prefill, and in each decode step."""
    per_call = [int(r["dropped"].sum()) for r in routes]
    steps = [sum(per_call[i:i + n_layers]) for i in range(0, len(per_call), n_layers)]
    return steps[0], steps[1:]


def _onehot_work(cfg, tokens: int, moe_layers: int | None = None) -> dict:
    """The onehot dispatch's expert work for ``tokens`` tokens at the
    config's capacity: every expert's MLP over all its capacity slots, and
    the dispatch and combine products, in every MoE layer of the config
    (or in ``moe_layers``)."""
    e, k, vs = cfg.moe_experts, cfg.moe_top_k, cfg.moe_virtual_split
    g = min(cfg.moe_group, tokens)
    while tokens % g:
        g //= 2
    cap = min(max(int(math.ceil(g * k / e * cfg.moe_capacity_factor)), 1), g)
    d, ev, fv = cfg.d_model, e * vs, cfg.moe_d_ff // vs
    per_group = 2 * ev * cap * 3 * d * fv + 2 * 2 * g * ev * cap * d
    layers = layer_counts(cfg)["moe"] if moe_layers is None else moe_layers
    flops = layers * (tokens // g) * per_group
    return {"group": g, "capacity": cap, "tflop": flops / 1e12,
            "bound_ms": 1e3 * flops / BF16_FLOPS_PER_S}


def upcast_in_place(tree) -> None:
    """Every tensor of a params tree to f32, leaf by leaf: each bf16 leaf is
    freed as its f32 copy is made, so the two trees are never whole at once."""
    for node in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(node, (dict, tuple, list)):
            upcast_in_place(node)
    if isinstance(tree, dict):
        for key, leaf in tree.items():
            if isinstance(leaf, torch.Tensor):
                tree[key] = leaf.float()


def moe_serve_phase(name: str, seed: int, dev: torch.device) -> dict:
    """An MoE config at full width through ``Server.generate``: the dropless
    row (capacity factor E/k) against the recurrence, route by route, then
    the published-capacity row on the same weights, then the f32 checks."""
    import dataclasses

    import numpy as np

    from repro_torch._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Server

    spec = MOE_SERVE[name]
    tol, steps = spec["logit_tol"], MOE_STEPS
    full = get_config(name)
    cfg = dataclasses.replace(full, num_layers=spec["layers"],
                              attn_impl="flash" if spec["flash"] else "ref",
                              moe_capacity_factor=full.moe_experts / full.moe_top_k)
    n_moe = layer_counts(cfg)["moe"]
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    param_count = sum(t.numel() for t in tree_leaves(params))
    embed = params["embed"]
    decode_bound_ms = 1e3 * (param_bytes - embed.numel() * embed.element_size()) / HBM_BYTES_PER_S
    prefill_bound_ms = prefill_matmul_bound_ms(cfg, params)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    prompt_t = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    v = cfg.vocab_size

    # ---- dropless: the served run against the recurrence, route by route ----
    server = Server(cfg, max_len=SERVE_MAX_LEN, device=dev)
    server.load(params)
    server.generate(prompts, steps=2)  # warm-up
    reset_launches()
    (tokens, stats, logits), served_routes = _recording_routes(
        lambda: server.generate(prompts, steps=steps, return_logits=True))
    launches = read_launches()
    bf16_split = split_launches()
    peak_bf16 = torch.cuda.max_memory_allocated(dev)
    served = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    lf = logits[:, :steps, :v].float()
    del logits
    rf, rec_routes = _recording_routes(
        lambda: recurrence_logits(model, params, prompt_t, served)[..., :v].float())
    served_sets = _per_layer(served_routes, n_moe)
    rec_sets = _per_layer(rec_routes, n_moe)
    flips = _route_flips(served_sets, rec_sets)              # (layers, B, positions)
    at = SERVE_PROMPT - 1 + torch.arange(steps, device=dev)   # the compared positions
    flipped = flips[:, :, at].any(0)                          # (B, steps)
    err = (lf - rf).abs().amax(-1)                            # (B, steps)
    held = ~flipped
    prefill_err = float(err[:, 0][held[:, 0]].max()) if held[:, 0].any() else None
    decode_err = float(err[:, 1:][held[:, 1:]].max()) if held[:, 1:].any() else None
    flipped_rows = [{"b": b, "step": t, "err": float(err[b, t]),
                     "layers": [i for i in range(n_moe) if flips[i, b, SERVE_PROMPT - 1 + t]]}
                    for b, t in flipped.nonzero().tolist()]
    ref_argmax = rf.argmax(-1)
    mismatch = ((ref_argmax != served) & held).nonzero().tolist()
    gaps = [float(rf[b, t, ref_argmax[b, t]] - rf[b, t, served[b, t]]) for b, t in mismatch]
    route_err = None
    if cfg.attn_impl == "flash":  # the ref route's prefill, where its routes agree
        ref_model = build_model(dataclasses.replace(cfg, attn_impl="ref"))
        cache = ref_model.init_cache(SERVE_BATCH, SERVE_MAX_LEN, dtype=torch.bfloat16, device=dev)
        with torch.no_grad():
            (ref_logits, _), ref_routes = _recording_routes(
                lambda: ref_model.prefill(params, {"tokens": prompt_t}, cache))
        del cache
        ref_flip = _route_flips(served_sets, _per_layer(ref_routes, n_moe))
        same = ~ref_flip[:, :, SERVE_PROMPT - 1].any(0)
        if same.any():
            route_err = float((ref_logits[:, :v].float() - lf[:, 0]).abs().amax(-1)[same].max())
        del ref_logits

    # ---- the published capacity on the same weights ----
    published = published_row(name, full, cfg, params, prompts, dev, decode_bound_ms)

    # ---- f32: the served path and the recurrence on the same weights upcast ----
    del server
    upcast_in_place(params)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model32 = build_model(dataclasses.replace(cfg, dtype="float32"))
    cache = model32.init_cache(SERVE_BATCH, SERVE_MAX_LEN, dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    split0, t0 = split_launches(), time.perf_counter()
    with torch.no_grad():
        (first, _), served32_routes = _recording_routes(
            lambda: model32.prefill(params, {"tokens": prompt_t}, cache))
    torch.cuda.synchronize()
    f32_prefill_ms = 1e3 * (time.perf_counter() - t0)
    f32_split = tuple(n - n0 for n, n0 in zip(split_launches(), split0))
    steps32 = [first]
    with torch.no_grad():
        for t in range(1, steps):
            (step, _), r = _recording_routes(lambda t=t: model32.decode_step(
                params, cache, served[:, t - 1:t], SERVE_PROMPT + t - 1))
            steps32.append(step)
            served32_routes += r
    del cache
    lf32 = torch.stack(steps32, 1)[..., :v]
    rf32, rec32_routes = _recording_routes(
        lambda: recurrence_logits(model32, params, prompt_t, served)[..., :v])
    peak_f32 = torch.cuda.max_memory_allocated(dev)
    f32_err = float((lf32 - rf32).abs().max())
    rec32_sets = _per_layer(rec32_routes, n_moe)
    f32_flips = _route_flips(_per_layer(served32_routes, n_moe), rec32_sets)
    # the yardstick: the bf16 recurrence against the f32 one, at the compared
    # positions where their routes agree
    yard_flip = _route_flips(rec_sets, rec32_sets)[:, :, at].any(0)
    yard = (rf - rf32).abs().amax(-1)
    bf16_self_err = float(yard[~yard_flip].max()) if (~yard_flip).any() else None
    del params, lf32, rf32
    torch.cuda.empty_cache()

    result = {
        "phase": "serve", "run": name, "arch": name, "d_model": cfg.d_model,
        "layers": cfg.num_layers, "layers_full": full.num_layers,
        "layer_counts": layer_counts(cfg), "attn_impl": cfg.attn_impl,
        "moe_capacity_factor": cfg.moe_capacity_factor,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "steps": steps,
        "max_len": SERVE_MAX_LEN, "dtype": cfg.dtype,
        "prefill_ms": stats.prefill_s * 1e3, "prefill_matmul_bound_ms": prefill_bound_ms,
        "prefill_onehot_expert_work": _onehot_work(cfg, SERVE_BATCH * SERVE_PROMPT),
        "decode_onehot_expert_work": _onehot_work(cfg, SERVE_BATCH),
        "decode_ms_per_token": stats.decode_s / steps * 1e3,
        "decode_bytes_bound_ms": decode_bound_ms,
        "times_with_route_recorder": True,
        "dispatches": stats.dispatches, "launches": launches,
        "max_memory_allocated": peak_bf16, "f32_max_memory_allocated": peak_f32,
        "param_bytes": param_bytes, "param_count": param_count, "init_s": init_s,
        "logit_max_abs": float(lf.abs().max()), "logit_std": float(lf.std()),
        "logit_tol": tol, "route_mismatches": [int(f.sum()) for f in flips],
        "route_positions": int(flips.shape[1] * flips.shape[2]),
        "flipped_compared_positions": flipped_rows,
        "compared_positions": int(flipped.numel()),
        "prefill_vs_recurrence": prefill_err, "decode_vs_recurrence": decode_err,
        "flash_vs_ref_prefill": route_err,
        "f32_prefill_vs_f32_recurrence_every_step": f32_err,
        "f32_route_mismatches": [int(f.sum()) for f in f32_flips],
        "f32_prefill_ms": f32_prefill_ms,
        "f32_prefill_flash_split_launches": f32_split[0],
        "f32_prefill_split_kv_launches": f32_split[1],
        "bf16_recurrence_vs_f32_recurrence": bf16_self_err,
        "bf16_vs_f32_recurrence_route_flips": int(yard_flip.sum()),
        "argmax_mismatches": len(mismatch), "mismatch_gaps": gaps,
    }
    emit(result)
    check(stats.dispatches == 1 + steps, f"{name}: dispatches {stats.dispatches}")
    want = expected_launches(cfg, launches)
    check(launches == want, f"{name}: prefill launches {launches} != {want} (from the segments)")
    check(bf16_split == (0, 0), f"{name}: the bf16 prefill takes no split-route flash launch")
    check(f32_split == (want["flash_attention"],) * 2, f"{name}: the f32 prefill launches the "
          f"flash kernel's split route once per attention layer: {f32_split}")
    check(bool(torch.isfinite(lf).all()), f"{name}: every logit is finite")
    check(len(flipped_rows) <= ROUTE_FLIP_SHARE * flipped.numel(),
          f"{name}: {len(flipped_rows)} of {flipped.numel()} compared positions route apart")
    check(prefill_err is not None and prefill_err <= tol,
          f"{name}: prefill vs recurrence {prefill_err} > {tol}")
    check(decode_err is not None and decode_err <= tol,
          f"{name}: decode vs recurrence {decode_err} > {tol}")
    if route_err is not None:
        check(route_err <= tol, f"{name}: flash vs ref route {route_err} > {tol}")
    check(f32_err <= F32_LOGIT_TOL, f"{name}: f32 served steps vs f32 recurrence {f32_err}")
    check(all(g <= tol for g in gaps), f"{name}: served tokens are the recurrence's argmax "
          f"except at near-ties: gaps {gaps}")
    return {"dropless": result, "published": published}


def published_row(name: str, full, cfg, params, prompts, dev: torch.device,
                  decode_bound_ms: float) -> dict:
    """The same weights at the config's own capacity factor (1.25): times,
    bounds, dropped choices and memory.  Not compared with the recurrence:
    drops depend on the group, and a prefill group holds 1024 tokens where a
    decode group holds 8."""
    import dataclasses

    import numpy as np

    from repro_torch.runtime import Server

    steps = MOE_STEPS
    pub = dataclasses.replace(cfg, moe_capacity_factor=full.moe_capacity_factor)
    n_moe = layer_counts(pub)["moe"]
    server = Server(pub, max_len=SERVE_MAX_LEN, device=dev)
    server.load(params)
    server.generate(prompts, steps=2)  # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    tokens, stats, logits = server.generate(prompts, steps=steps, return_logits=True)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    finite = bool(torch.isfinite(logits[..., :pub.vocab_size]).all())
    del logits
    # the same run again with the route recorder on, for the drop counts
    (again, _), routes = _recording_routes(lambda: server.generate(prompts, steps=steps))
    prefill_drops, decode_drops = _drops(routes, n_moe)
    tokens_x_choices = pub.moe_top_k * n_moe
    row = {
        "phase": "serve", "run": f"{name}/published", "arch": name,
        "layers": pub.num_layers, "moe_capacity_factor": pub.moe_capacity_factor,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "steps": steps, "dtype": pub.dtype,
        "prefill_ms": stats.prefill_s * 1e3,
        "prefill_matmul_bound_ms": prefill_matmul_bound_ms(pub, params),
        "prefill_onehot_expert_work": _onehot_work(pub, SERVE_BATCH * SERVE_PROMPT),
        "decode_ms_per_token": stats.decode_s / steps * 1e3,
        "decode_bytes_bound_ms": decode_bound_ms,
        "decode_onehot_expert_work": _onehot_work(pub, SERVE_BATCH),
        "dispatches": stats.dispatches, "launches": launches,
        "dropped_prefill": prefill_drops,
        "dropped_prefill_of": SERVE_BATCH * SERVE_PROMPT * tokens_x_choices,
        "dropped_per_decode_step": decode_drops,
        "dropped_decode_step_of": SERVE_BATCH * tokens_x_choices,
        "same_tokens_with_recorder": bool(np.array_equal(tokens, again)),
        "max_memory_allocated": peak,
    }
    emit(row)
    check(finite, f"{name}/published: every logit is finite")
    check(stats.dispatches == 1 + steps, f"{name}/published: dispatches {stats.dispatches}")
    check(launches == expected_launches(pub, launches),
          f"{name}/published: prefill launches {launches}")
    check(row["same_tokens_with_recorder"], f"{name}/published: the recorder changes no token")
    return row


def set_gates(tree, value: float) -> None:
    """Every cross-attention ``gate`` leaf of a params tree filled with
    ``value``, in place."""
    for key, node in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(node, (dict, tuple, list)):
            set_gates(node, value)
        elif key == "gate":
            node.fill_(value)


def cross_extras(cfg, seed: int, dev: torch.device) -> dict:
    """The stubbed frontend's output for a batch of ``SERVE_BATCH`` prompts,
    bf16, drawn from ``seed``: whisper's ``frames``, the vlm's
    ``image_embeds`` (normal rows plus one shared normal row per image,
    ``CROSS_SERVE``); empty for the other families."""
    m = memory_tokens(cfg)
    if cfg.family == "audio":
        key, shape = "frames", (SERVE_BATCH, m, cfg.d_model)
    elif cfg.family == "vlm":
        key, shape = "image_embeds", (SERVE_BATCH, m, cfg.image_embed_dim)
    else:
        return {}
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    memory_in = torch.randn(shape, generator=gen, device=dev)
    if cfg.family == "vlm":  # one shared row per image (CROSS_SERVE)
        memory_in += torch.randn((SERVE_BATCH, 1, shape[2]), generator=gen, device=dev)
    return {key: memory_in.to(torch.bfloat16)}


def cross_serve_phase(name: str, seed: int, dev: torch.device) -> dict:
    """A cross-attention config at full width through ``Server.generate``
    with its stubbed frontend's output as ``extras``, checked against the
    recurrence handed the same memory, the ref route, and the same prefill
    with every gate at 0."""
    import dataclasses

    import numpy as np

    from repro_torch._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Server

    spec = CROSS_SERVE[name]
    tol, steps = spec["logit_tol"], CROSS_STEPS
    full = get_config(name)
    cfg = dataclasses.replace(full, attn_impl="flash", **spec["overrides"])
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    set_gates(params, CROSS_GATE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    m = memory_tokens(cfg)
    extras = cross_extras(cfg, seed, dev)
    key, shape = next(iter(extras)), tuple(next(iter(extras.values())).shape)
    param_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    param_count = _numel(params)
    # a decode step reads every weight but the encoder's and the embedding's
    # (of which it gathers 8 rows; a tied head reads it whole)
    encoder_bytes = sum(t.numel() * t.element_size() for k, v in params.items()
                        if k.startswith("enc_") for t in tree_leaves(v))
    embed = params["embed"]
    gathered = 0 if cfg.tie_embeddings else embed.numel() * embed.element_size()
    decode_bound_ms = 1e3 * (param_bytes - gathered - encoder_bytes) / HBM_BYTES_PER_S
    prefill_bound_ms = prefill_matmul_bound_ms(cfg, params)
    # the vlm's decode step projects its memory again in every cross layer
    mem_params = sum(_numel(v, {"wk_mem", "wv_mem"}) for k, v in params.items()
                     if k.startswith("seg"))
    reproject_flop = 2 * SERVE_BATCH * m * mem_params if cfg.family == "vlm" else 0
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    prompt_t = torch.as_tensor(prompts, dtype=torch.int64, device=dev)
    batch = {"tokens": prompt_t, **extras}
    v = cfg.vocab_size

    server = Server(cfg, max_len=SERVE_MAX_LEN, device=dev)
    server.load(params)
    server.generate(prompts, steps=2, extras=extras)  # warm-up
    reset_launches()
    tokens, stats, logits = server.generate(prompts, steps=steps, extras=extras,
                                            return_logits=True)
    launches = read_launches()
    bf16_split = split_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    served = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    lf = logits[:, :steps, :v].float()
    del logits, server
    with torch.no_grad():
        memory = model._memory(params, extras)  # the encoder's output, or the image embeddings
    rf = recurrence_logits(model, params, prompt_t, served, memory)[..., :v].float()
    del memory
    prefill_err = float((lf[:, 0] - rf[:, 0]).abs().max())
    decode_err = float((lf[:, 1:] - rf[:, 1:]).abs().max())
    ref_argmax = rf.argmax(-1)
    mismatch = (ref_argmax != served).nonzero().tolist()
    gaps = [float(rf[b, t, ref_argmax[b, t]] - rf[b, t, served[b, t]]) for b, t in mismatch]
    ref_model = build_model(dataclasses.replace(cfg, attn_impl="ref"))
    cache = ref_model.init_cache(SERVE_BATCH, SERVE_MAX_LEN, dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        ref_logits, _ = ref_model.prefill(params, batch, cache)
    route_err = float((ref_logits[:, :v].float() - lf[:, 0]).abs().max())
    # the same prefill with every gate at 0: the memory must reach the logits
    set_gates(params, 0.0)
    cache = model.init_cache(SERVE_BATCH, SERVE_MAX_LEN, dtype=torch.bfloat16, device=dev)
    with torch.no_grad():
        ungated, _ = model.prefill(params, batch, cache)
    set_gates(params, CROSS_GATE)
    gate_diff = float((ungated[:, :v].float() - lf[:, 0]).abs().max())
    del cache, ref_logits, ungated
    torch.cuda.reset_peak_memory_stats(dev)
    prefill32, rec32, f32_prefill_ms, f32_split = f32_reference(cfg, params, prompt_t, extras)
    peak_f32 = torch.cuda.max_memory_allocated(dev)
    f32_err = float((prefill32 - rec32).abs().max())
    bf16_self_err = float((rf[:, 0] - rec32).abs().max())
    served_vs_f32 = float((lf[:, 0] - rec32).abs().max())
    del prefill32, rec32, params
    result = {
        "phase": "serve", "run": name, "arch": name, "d_model": cfg.d_model,
        "layers": cfg.num_layers, "layers_full": full.num_layers,
        "encoder_layers": cfg.encoder_layers, "layer_counts": layer_counts(cfg),
        "attn_impl": cfg.attn_impl, "memory": {key: list(shape)}, "gate": CROSS_GATE,
        "batch": SERVE_BATCH, "prompt": SERVE_PROMPT, "steps": steps,
        "max_len": SERVE_MAX_LEN, "dtype": cfg.dtype,
        "prefill_ms": stats.prefill_s * 1e3, "prefill_matmul_bound_ms": prefill_bound_ms,
        "decode_ms_per_token": stats.decode_s / steps * 1e3,
        "decode_bytes_bound_ms": decode_bound_ms,
        "decode_memory_reprojection_tflop": reproject_flop / 1e12,
        "decode_memory_reprojection_ms_at_peak": 1e3 * reproject_flop / BF16_FLOPS_PER_S,
        "decode_tokens_per_s": stats.tokens_out / stats.decode_s,
        "prefill_tokens_per_s": SERVE_BATCH * SERVE_PROMPT / stats.prefill_s,
        "dispatches": stats.dispatches, "launches": launches,
        "max_memory_allocated": peak, "f32_max_memory_allocated": peak_f32,
        "param_bytes": param_bytes, "encoder_param_bytes": encoder_bytes,
        "param_count": param_count, "init_s": init_s,
        "logit_max_abs": float(lf.abs().max()), "logit_std": float(lf.std()),
        "logit_tol": tol, "prefill_vs_recurrence": prefill_err,
        "decode_vs_recurrence": decode_err, "flash_vs_ref_prefill": route_err,
        "zero_gate_prefill_diff": gate_diff,
        "f32_prefill_vs_f32_recurrence": f32_err, "f32_prefill_ms": f32_prefill_ms,
        "f32_prefill_flash_split_launches": f32_split[0],
        "f32_prefill_split_kv_launches": f32_split[1],
        "bf16_recurrence_vs_f32_recurrence": bf16_self_err,
        "prefill_vs_f32_recurrence": served_vs_f32, "argmax_mismatches": len(mismatch),
        "mismatch_gaps": gaps,
    }
    emit(result)
    check(stats.dispatches == 1 + steps, f"{name}: dispatches {stats.dispatches}")
    want = expected_launches(cfg, launches)
    check(launches == want, f"{name}: prefill launches {launches} != {want} (one flash "
          f"launch per self-, encoder and cross-attention layer)")
    check(bf16_split == (0, 0), f"{name}: the bf16 prefill takes no split-route flash launch "
          f"({bf16_split})")
    check(f32_split == (want["flash_attention"],) * 2, f"{name}: the f32 prefill launches the "
          f"flash kernel's split route and its split kernel once per attention layer: "
          f"{f32_split}")
    check(bool(torch.isfinite(lf).all()), f"{name}: every logit is finite")
    check(prefill_err <= tol, f"{name}: prefill vs recurrence {prefill_err} > {tol}")
    check(decode_err <= tol, f"{name}: decode vs recurrence {decode_err} > {tol}")
    check(route_err <= tol, f"{name}: flash vs ref route {route_err} > {tol}")
    check(gate_diff > tol, f"{name}: the prefill with every gate at 0 differs from the served "
          f"one by {gate_diff}, not more than {tol}: the memory does not reach the logits")
    check(f32_err <= F32_LOGIT_TOL, f"{name}: f32 prefill vs f32 recurrence {f32_err}")
    check(all(g <= tol for g in gaps), f"{name}: served tokens are the recurrence's argmax "
          f"except at near-ties: gaps {gaps}")
    return result


def moe_phase(seed: int, dev: torch.device) -> list[dict]:
    """One MoE layer of mixtral (virtual split 2) and of jamba at full width
    and the published capacity factor, ``moe_mlp`` against the plain
    per-expert version (``repro_torch.models.moe_ref``): 4096 tokens in
    groups of 1024 (rows tilted by one shared random row, so that experts
    are over-subscribed and the capacity drops choices) and decode-sized
    groups of 8, in f32 and bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models.moe import init_moe, moe_mlp
    from repro_torch.models.moe_ref import moe_plain

    rows = []
    for arch in ("mixtral-8x7b", "jamba-v0.1-52b"):
        cfg = get_config(arch)
        gen = torch.Generator(device=dev).manual_seed(seed + 3)
        p = init_moe(cfg, generator=gen, device=dev, dtype=torch.bfloat16)
        d = cfg.d_model
        x = torch.randn((MOE_TOKENS // cfg.moe_group, cfg.moe_group, d), generator=gen, device=dev)
        x = (x + MOE_SKEW * torch.randn((d,), generator=gen, device=dev)).to(torch.bfloat16)
        steps = [torch.randn((SERVE_BATCH, 1, d), generator=gen, device=dev).to(torch.bfloat16)
                 for _ in range(MOE_DECODE_GROUPS)]
        row = {"phase": "moe", "arch": arch, "d_model": d, "experts": cfg.moe_experts,
               "top_k": cfg.moe_top_k, "virtual_split": cfg.moe_virtual_split,
               "moe_d_ff": cfg.moe_d_ff, "capacity_factor": cfg.moe_capacity_factor,
               "tokens": MOE_TOKENS, "skew": MOE_SKEW, "decode_groups": MOE_DECODE_GROUPS,
               "decode_group_tokens": SERVE_BATCH,
               "prefill_work": _onehot_work(cfg, MOE_TOKENS, moe_layers=1),
               "tolerance": {"float32": f"allclose {F32_TOL}",
                             "bfloat16": f"allclose {BF16_TOL} where the routes agree"}}
        for dtype in (torch.bfloat16, torch.float32):
            tag = "f32" if dtype == torch.float32 else "bf16"
            if dtype == torch.float32:
                p = {k: t.float() for k, t in p.items()}
                x, steps = x.float(), [t.float() for t in steps]
            drops = {}
            for case, inputs in (("tokens4096", [x]), ("decode8", steps)):
                errs, agree_all, dropped_n = [], 0, 0
                for xi in inputs:
                    got, routes = _recording_routes(lambda xi=xi: moe_mlp(p, cfg, xi))
                    (rec,) = routes
                    want, experts, dropped = moe_plain(p, cfg, xi)
                    agree = ((rec["experts"] == experts) & (rec["dropped"] == dropped)).all(-1)
                    if dtype == torch.float32:
                        check(torch.equal(rec["experts"], experts)
                              and torch.equal(rec["dropped"], dropped),
                              f"moe {arch} {case} f32: the routes and drop sets are equal")
                        check(torch.allclose(got, want, **F32_TOL),
                              f"moe {arch} {case} f32: within {F32_TOL} of the plain version")
                        errs.append(float((got - want).abs().max()))
                    else:
                        g, w = got[agree].float(), want[agree].float()
                        check(torch.allclose(g, w, **BF16_TOL), f"moe {arch} {case} bf16: within "
                              f"{BF16_TOL} of the plain version where the routes agree")
                        errs.append(float((g - w).abs().max()))
                    agree_all += int(agree.sum())
                    dropped_n += int(dropped.sum())
                drops[case] = dropped_n
                row[f"{tag}_{case}"] = {"max_abs_err": max(errs), "dropped": dropped_n,
                                        "choices": sum(t.shape[0] * t.shape[1] for t in inputs)
                                        * cfg.moe_top_k,
                                        "tokens_routes_agree": agree_all}
            check(drops["decode8"] > 0, f"moe {arch} {tag}: the decode-sized groups drop")
            row[f"{tag}_ms"] = cuda_ms(lambda: moe_mlp(p, cfg, x), reps=5)
            row[f"{tag}_plain_ms"] = cuda_ms(lambda: moe_plain(p, cfg, x), reps=5)
        emit(row)
        rows.append(row)
        del p, x, steps
        torch.cuda.empty_cache()
    return rows


def flash_cross_cases(normal) -> list[dict]:
    """The flash kernel at the encoder's and cross-attention's shapes
    (``CROSS_FLASH_SHAPES``: not causal, Lk not a multiple of the 128-row
    tile), in bf16 (the wgmma route) and f32 (the split route), each beside
    its plain version and SDPA, with its bound; ``normal(*shape, dtype=)``
    draws the inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b = SERVE_BATCH
    cross_cases = []
    for label, (lq, lk, hq, hk, dh) in CROSS_FLASH_SHAPES.items():
        row = {"case": label, "shape_q": [b, lq, hq, dh], "shape_kv": [b, lk, hk, dh],
               "causal": False}
        for dtype, tol, tag in ((torch.bfloat16, BF16_TOL, ""), (torch.float32, F32_TOL, "f32_")):
            qc, kc, vc = (normal(b, n, hh, dh, dtype=dtype) for n, hh in ((lq, hq), (lk, hk),
                                                                          (lk, hk)))
            gotc = fa.flash_attention(qc, kc, vc, causal=False)
            wantc = fa.flash_attention_ref(qc, kc, vc, causal=False)
            errc = float((gotc.float() - wantc.float()).abs().max())
            check(torch.allclose(gotc.float(), wantc.float(), **tol),
                  f"flash_attention {label} ({dtype}) within {tol} of its plain version ({errc})")
            sdpa_c = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qc.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), enable_gqa=True)
            size = 2 if dtype == torch.bfloat16 else 4
            bound_c, bound_c_by = bound(size * (2 * qc.numel() + kc.numel() + vc.numel()),
                                        4 * dh * lq * lk * b * hq, BF16_FLOPS_PER_S)
            times = kernel_times(lambda: fa.flash_attention(qc, kc, vc, causal=False))
            row.update({f"{tag}{k}": t for k, t in times.items()})
            row.update({f"{tag}max_abs_err": errc,
                        f"{tag}plain_ms": cuda_ms(lambda: fa.flash_attention_ref(
                            qc, kc, vc, causal=False)),
                        f"{tag}bound_ms": bound_c, f"{tag}bound_by": bound_c_by,
                        f"{tag}library_ms": cuda_ms(sdpa_c),
                        f"{tag}library_max_abs_diff": float(
                            (sdpa_c().transpose(1, 2).float() - gotc.float()).abs().max())})
            del qc, kc, vc, gotc, wantc
        cross_cases.append(row)
    return cross_cases


def flash_tensor_parallel_cases(normal, shapes: dict | None = None) -> list[dict]:
    """The flash kernel at the shapes a tensor-parallel rank of the
    ``tensor_parallel`` phase launches it (``TP_FLASH_SHAPES``: qwen3-32b's,
    mixtral's and jamba's heads over 4 and 16 ranks, with one kv head at
    16, causal over the prompt (mixtral's with its window); the vlm's cross
    layer, not causal over its memory of 1600 image tokens), or of the
    ``long_decode`` phase's prefill (``LD_FLASH_SHAPES``, whose entries add
    the batch and the prompt's length to the serve phase's), bf16, each
    beside its plain version and SDPA, with its bound; ``normal(*shape)``
    draws the inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    d = 128
    rows = []
    for label, (h, hkv, window, memory, *bl) in (shapes or TP_FLASH_SHAPES).items():
        b, l = bl or (SERVE_BATCH, SERVE_PROMPT)
        causal, lk = not memory, memory or l
        q, k, v = normal(b, l, h, d), normal(b, lk, hkv, d), normal(b, lk, hkv, d)
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = float((got.float() - want.float()).abs().max())
        check(torch.allclose(got.float(), want.float(), **BF16_TOL),
              f"flash_attention {label} within {BF16_TOL} of its plain version ({err})")
        mask = None  # a window shorter than the prompt: SDPA takes the band as a mask
        if causal and window and window < l:
            at = torch.arange(l, device=q.device)
            mask = (at[None, :] <= at[:, None]) & (at[None, :] > at[:, None] - window)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
            is_causal=causal and mask is None, enable_gqa=True)
        pairs = (sum(min(i + 1, window or i + 1) for i in range(l)) if causal
                 else l * lk)  # kept (q, k) pairs
        bound_ms, bound_by = bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                                   4 * d * pairs * b * h, BF16_FLOPS_PER_S)
        rows.append({"case": label, "shape_q": [b, l, h, d], "shape_kv": [b, lk, hkv, d],
                     "causal": causal, "window": window, "max_abs_err": err,
                     "tolerance": f"allclose {BF16_TOL}",
                     **kernel_times(lambda: fa.flash_attention(q, k, v, causal=causal,
                                                               window=window)),
                     "plain_ms": cuda_ms(lambda: fa.flash_attention_ref(q, k, v, causal=causal,
                                                                        window=window)),
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": cuda_ms(sdpa),
                     "library": "scaled_dot_product_attention" + (
                         "(attn_mask: the window's band)" if mask is not None else ""),
                     "library_max_abs_diff": float(
                         (sdpa().transpose(1, 2).float() - got.float()).abs().max())})
        del q, k, v, got, want, mask
    return rows


def ssd_tensor_parallel_cases(normal, gen, shapes: dict | None = None) -> list[dict]:
    """The SSD kernel at the shapes a tensor-parallel rank of the
    ``tensor_parallel`` phase launches it (``TP_SSD_SHAPES``: mamba2-1.3b's
    and jamba's heads over 4 and 16 ranks) or of the ``long_decode``
    phase's prefill (``LD_SSD_SHAPES``, with the batch and the prompt's
    length), bf16 in as the served route takes it, each against its plain
    version (``ssd_chunked``) on the same inputs upcast, with its bound (the
    formula of the ``ssd_scan`` row); ``normal(*shape)`` and ``gen`` draw
    the inputs."""
    from repro_torch.kernels import ssd_scan as ss

    p, qc = 64, 64
    dev = gen.device
    rows = []
    for label, (nh, n, *bl) in (shapes or TP_SSD_SHAPES).items():
        b, l = bl or (SERVE_BATCH, SERVE_PROMPT)
        dt = (torch.rand((b, l, nh), generator=gen, device=dev) * 0.8 + 0.1).to(torch.bfloat16)
        a = (-(torch.rand((nh,), generator=gen, device=dev) + 0.5)).to(torch.bfloat16)
        inputs = (normal(b, l, nh, p), dt, a, normal(b, l, n), normal(b, l, n))
        ry, rh = ss.ssd_chunked(*(t.float() for t in inputs), chunk=256)
        y, h = ss.ssd_scan(*inputs, chunk=256)
        y_err, h_err = float((y.float() - ry).abs().max()), float((h - rh).abs().max())
        check(torch.allclose(y.float(), ry, **BF16_TOL) and torch.allclose(h, rh, **SSD_TOL),
              f"ssd_scan {label} (bf16 in) y within {BF16_TOL} ({y_err}), the state within "
              f"{SSD_TOL} ({h_err}) of its plain version")
        tri = qc * (qc + 1) // 2
        mac = b * (l // qc) * (tri * n + nh * 2 * (tri * p + 2 * qc * p * n))
        bound_ms, bound_by = bound(
            sum(t.numel() * t.element_size() for t in inputs) + y.numel() * 2 + h.numel() * 4,
            2 * mac, BF16_FLOPS_PER_S)
        rows.append({"case": label, "shape_x": [b, l, nh, p], "state": n,
                     "max_abs_err": y_err, "state_max_abs_err": h_err,
                     "tolerance": f"y allclose {BF16_TOL}, state allclose {SSD_TOL} of the f32 "
                                  f"plain version",
                     **kernel_times(lambda: ss.ssd_scan(*inputs, chunk=256)),
                     "plain_ms": cuda_ms(lambda: ss.ssd_chunked(*inputs, chunk=256)),
                     "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None})
        del inputs, ry, rh, y, h
    return rows


def lm_kernel_checks(seed: int, dev: torch.device, x_values: torch.Tensor,
                     launches: dict, by_run: dict) -> list[dict]:
    """The serving path's kernels (and the value histogram) at their main
    paths' shapes, against their plain versions.  ``launches`` holds each
    kernel's launches summed over the serve runs, ``by_run`` each run's."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import partition_reduce as pr
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    out = []
    # ---- flash_attention: one qwen3 prefill layer ----
    b, l, h, hkv, d = SERVE_BATCH, SERVE_PROMPT, 64, 8, 128
    q, k, v = normal(b, l, h, d), normal(b, l, hkv, d), normal(b, l, hkv, d)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True)
    err = float((got.float() - want.float()).abs().max())
    check(torch.allclose(got.float(), want.float(), **BF16_TOL),
          f"flash_attention within {BF16_TOL} of its plain version ({err})")
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True)
    lib_err = float((sdpa().transpose(1, 2).float() - got.float()).abs().max())
    # a query row no key reaches is 0 (rows >= 16 + 4 - 1 with 16 keys, window 4)
    qm, km, vm = normal(1, 64, 4, d), normal(1, 16, 1, d), normal(1, 16, 1, d)
    masked = fa.flash_attention(qm, km, vm, causal=True, window=4)
    check(bool((masked[:, 19:] == 0).all()), "flash_attention: fully masked rows are 0")
    check(torch.allclose(masked.float(), fa.flash_attention_ref(qm, km, vm, causal=True, window=4)
                         .float(), **BF16_TOL), "flash_attention masked rows vs plain")
    # mixtral's 4096 window on a sequence long enough to skip tiles
    qw, kw, vw = normal(1, 6144, 8, d), normal(1, 6144, 2, d), normal(1, 6144, 2, d)
    win = fa.flash_attention(qw, kw, vw, causal=True, window=4096)
    win_err = float((win.float() - fa.flash_attention_ref(qw, kw, vw, causal=True, window=4096)
                     .float()).abs().max())
    check(win_err <= BF16_TOL["atol"] + BF16_TOL["rtol"] * float(win.float().abs().max()),
          f"flash_attention window 4096 vs plain ({win_err})")
    win_ms = cuda_ms(lambda: fa.flash_attention(qw, kw, vw, causal=True, window=4096))
    del qw, kw, vw, win
    # other head dims, a ragged Lq and group 1 (the two warpgroups then take
    # 128 consecutive rows of one head), each beside its plain version and SDPA
    cases = []
    for label, (lq, hq, hk, dh) in {"d64": (l, h, hkv, 64), "d32": (l, h, hkv, 32),
                                    "ragged_lq500": (500, h, hkv, d),
                                    "group1": (l, hkv, hkv, d),
                                    "mixtral_jamba_heads32_kv8": (l, 32, 8, d)}.items():
        qc, kc, vc = normal(b, lq, hq, dh), normal(b, lq, hk, dh), normal(b, lq, hk, dh)
        gotc = fa.flash_attention(qc, kc, vc, causal=True)
        wantc = fa.flash_attention_ref(qc, kc, vc, causal=True)
        errc = float((gotc.float() - wantc.float()).abs().max())
        check(torch.allclose(gotc.float(), wantc.float(), **BF16_TOL),
              f"flash_attention {label} within {BF16_TOL} of its plain version ({errc})")
        sdpa_c = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qc.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2), is_causal=True,
            enable_gqa=True)
        cases.append({"case": label, "shape_q": [b, lq, hq, dh], "shape_kv": [b, lq, hk, dh],
                      "max_abs_err": errc,
                      "ms": cuda_ms(lambda: fa.flash_attention(qc, kc, vc, causal=True)),
                      "library_ms": cuda_ms(sdpa_c)})
        del qc, kc, vc, gotc, wantc
    cross_cases = flash_cross_cases(normal)
    tp_cases = flash_tensor_parallel_cases(normal)
    long_cases = flash_tensor_parallel_cases(normal, LD_FLASH_SHAPES)
    pairs = l * (l + 1) // 2  # causal (q, k) pairs per (batch, head)
    bound_ms, bound_by = bound(2 * (q.numel() + k.numel() + v.numel() + got.numel()),
                               4 * d * pairs * b * h, BF16_FLOPS_PER_S)
    # the split route in f32 at the same shapes: the f32 qwen3 prefill's layer
    q32, k32, v32 = (normal(*t.shape, dtype=torch.float32) for t in (q, k, v))
    got32 = fa.flash_attention(q32, k32, v32, causal=True)
    want32 = fa.flash_attention_ref(q32, k32, v32, causal=True)
    err32 = float((got32 - want32).abs().max())
    check(torch.allclose(got32, want32, **F32_TOL),
          f"flash_attention (split, f32) within {F32_TOL} of its plain version ({err32})")
    # q and k at 1 to 6 times the scale (exact in f32): each output beside
    # the plain version in f64 and beside the kernel's arithmetic emulated
    # with f32 matrix products (flash_attention_emulated), which tells the
    # split's rounding from the tensor cores' summing.  Checked: scale 2
    # within F32_TOL of the f32 plain version, scale 3 of the f64 one.
    scores = {}
    for sc in (1, 2, 3, 4, 6):
        qs, ks = sc * q32, sc * k32
        got_s = fa.flash_attention(qs, ks, v32, causal=True)
        plain_s = fa.flash_attention_ref(qs, ks, v32, causal=True)
        truth = fa.flash_attention_ref(qs.double(), ks.double(), v32.double(), causal=True)
        emul = fa.flash_attention_emulated(qs, ks, v32, causal=True)
        row = {"qk_scale": sc, "max_abs_err": float((got_s - plain_s).abs().max()),
               "emulated_max_abs_err": float((emul - plain_s).abs().max())}
        for name, x in (("", got_s), ("plain_", plain_s), ("emulated_", emul)):
            row[f"{name}f64_max_abs_err"] = float((x.double() - truth).abs().max())
        row["within_tol_of_f32_plain"] = bool(torch.allclose(got_s, plain_s, **F32_TOL))
        row["within_tol_of_f64_plain"] = bool(torch.allclose(got_s.double(), truth, **F32_TOL))
        row["plain_within_tol_of_f64_plain"] = bool(
            torch.allclose(plain_s.double(), truth, **F32_TOL))
        scores[sc] = row
        del qs, ks, got_s, plain_s, truth, emul
    check(scores[2]["within_tol_of_f32_plain"],
          f"flash_attention (split, f32, q and k x2) within {F32_TOL} of plain "
          f"({scores[2]['max_abs_err']})")
    check(scores[3]["within_tol_of_f64_plain"],
          f"flash_attention (split, f32, q and k x3) within {F32_TOL} of the f64 plain version "
          f"({scores[3]['f64_max_abs_err']})")
    # the split kernel's terms sum back to K and V bit for bit
    kt, vt = fa.split_kv(k32, v32)
    for x, t in ((k32, kt), (v32, vt)):
        check(torch.equal((t[0].float() + t[1].float()) + t[2].float(), x),
              "split_kv: hi + mid + lo equals the f32 input bit for bit")
    del kt, vt
    sdpa32 = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q32.transpose(1, 2), k32.transpose(1, 2), v32.transpose(1, 2), is_causal=True,
        enable_gqa=True)
    # a bf16 head dim the wgmma route does not take (16, as the reference tests it)
    q16, k16, v16 = normal(b, l, h, 16), normal(b, l, hkv, 16), normal(b, l, hkv, 16)
    got16 = fa.flash_attention(q16, k16, v16, causal=True).float()
    want16 = fa.flash_attention_ref(q16, k16, v16, causal=True).float()
    err16 = float((got16 - want16).abs().max())
    check(torch.allclose(got16, want16, **BF16_TOL),
          f"flash_attention (split, bf16, head dim 16) within {BF16_TOL} of plain ({err16})")
    # the function's own work: the f32 bytes of q, k, v and o, or one product
    # per causal (q, k) pair at the card's fastest rate (989 TFLOP/s: the
    # route gets f32 accuracy from bf16 products).  The route's six bf16
    # products are its own work, beside it as split_work_ms.
    split_bound_ms, split_bound_by = bound(
        4 * (q32.numel() + k32.numel() + v32.numel() + got32.numel()),
        4 * d * pairs * b * h, BF16_FLOPS_PER_S)
    split_work_ms = 1e3 * 6 * 4 * d * pairs * b * h / BF16_FLOPS_PER_S
    # K and V read in f32, their three bf16 terms written
    split_kv_bound_ms, _ = bound(4 * 2 * k32.numel() + 6 * 2 * k32.numel(), 0)
    split_route = {
        "route": "split", "dtype": "float32", "launches": launches["flash_attention_split"],
        "launches_per_call": by_run["qwen3-32b/f32"]["flash_attention_split"],
        "split_kv_launches": launches["split_kv"],
        "launches_by_run": {run: n["flash_attention_split"] for run, n in by_run.items()
                            if n.get("flash_attention_split")},
        "per_call_of": f"qwen3-32b f32 prefill ({SERVE_QWEN3_LAYERS} layers)", "max_abs_err": err32,
        "tolerance": f"allclose {F32_TOL} (tests/test_kernels.py TOL[float32])",
        "qk_scales": list(scores.values()),
        **kernel_times(lambda: fa.flash_attention(q32, k32, v32, causal=True)),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_ref(q32, k32, v32, causal=True)),
        "bound_ms": split_bound_ms, "bound_by": split_bound_by,
        "bound": "the f32 bytes of q, k, v and o, or one product of the causal pairs at "
                 "989 TFLOP/s",
        "split_work_ms": split_work_ms,
        "split_work": "the route's six bf16 products of the causal pairs at 989 TFLOP/s",
        "library_ms": cuda_ms(sdpa32),
        "library": "scaled_dot_product_attention on the same f32 inputs",
        "library_max_abs_diff": float((sdpa32().transpose(1, 2) - got32).abs().max()),
        "split_kv_ms": cuda_ms(lambda: fa.split_kv(k32, v32)),
        "split_kv_device_ms": device_and_host_ms(lambda: fa.split_kv(k32, v32))[0],
        "split_kv_bound_ms": split_kv_bound_ms,
        "bf16_head_dim16_max_abs_err": err16,
        "bf16_head_dim16_ms": cuda_ms(lambda: fa.flash_attention(q16, k16, v16, causal=True)),
    }
    del q32, k32, v32, got32, want32, q16, k16, v16, got16, want16
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:101",
        "launches": launches["flash_attention"], "max_abs_err": err,
        "launches_per_call": by_run["qwen3-32b"]["flash_attention"],
        "per_call_of": f"qwen3-32b prefill ({SERVE_QWEN3_LAYERS} layers)",
        "launches_by_run": {run: n["flash_attention"] for run, n in by_run.items()
                            if n.get("flash_attention")},
        "tolerance": f"allclose {BF16_TOL} (bf16 output)",
        **kernel_times(lambda: fa.flash_attention(q, k, v, causal=True)),
        "plain_ms": cuda_ms(lambda: fa.flash_attention_ref(q, k, v, causal=True)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": cuda_ms(sdpa),
        "library": "torch.nn.functional.scaled_dot_product_attention(is_causal, enable_gqa)",
        "library_max_abs_diff": lib_err, "shape_q": [b, l, h, d], "shape_kv": [b, l, hkv, d],
        "window4096_shape_q": [1, 6144, 8, d], "window4096_max_abs_err": win_err,
        "window4096_ms": win_ms, "cases": cases, "cross_cases": cross_cases,
        "tensor_parallel_cases": tp_cases, "long_decode_cases": long_cases,
        "split_route": split_route,
    })
    del q, k, v, got, want

    # ---- ssd_scan: one mamba2-1.3b prefill layer ----
    b, l, nh, p, n = SERVE_BATCH, SERVE_PROMPT, 64, 64, 128
    x = normal(b, l, nh, p)
    dt = (torch.rand((b, l, nh), generator=gen, device=dev) * 0.8 + 0.1).to(torch.bfloat16)
    a = (-(torch.rand((nh,), generator=gen, device=dev) + 0.5)).to(torch.bfloat16)
    bm, cm = normal(b, l, n), normal(b, l, n)
    inputs = (x, dt, a, bm, cm)
    up = tuple(t.float() for t in inputs)
    y32, h32 = ss.ssd_scan(*up, chunk=256)
    ry, rh = ss.ssd_chunked(*up, chunk=256)
    err = max(float((y32 - ry).abs().max()), float((h32 - rh).abs().max()))
    check(torch.allclose(y32, ry, **SSD_TOL) and torch.allclose(h32, rh, **SSD_TOL),
          f"ssd_scan (f32) within {SSD_TOL} of its plain version ({err})")
    # the served route: bf16 in, f32 inside, y rounded to bf16, the state in f32
    ybf, hbf = ss.ssd_scan(*inputs, chunk=256)
    check(ybf.dtype == torch.bfloat16 and hbf.dtype == torch.float32,
          f"ssd_scan (bf16 in) returns y {ybf.dtype} and the state {hbf.dtype}")
    bf16_err = float((ybf.float() - ry).abs().max())
    bf16_state_err = float((hbf - rh).abs().max())
    check(torch.allclose(ybf.float(), ry, **BF16_TOL),
          f"ssd_scan (bf16 in/out) y within {BF16_TOL} of the f32 plain version ({bf16_err})")
    check(torch.allclose(hbf, rh, **SSD_TOL),
          f"ssd_scan (bf16 in) state within {SSD_TOL} of the f32 plain version "
          f"({bf16_state_err})")
    # f32 inputs that are not bf16 values: the kernel splits them into three
    # bf16 terms (its six-product route)
    raw = (torch.randn((b, l, nh, p), generator=gen, device=dev),
           torch.rand((b, l, nh), generator=gen, device=dev) * 0.8 + 0.1,
           -(torch.rand((nh,), generator=gen, device=dev) + 0.5),
           torch.randn((b, l, n), generator=gen, device=dev),
           torch.randn((b, l, n), generator=gen, device=dev))
    y6, h6 = ss.ssd_scan(*raw, chunk=256)
    ry6, rh6 = ss.ssd_chunked(*raw, chunk=256)
    f32_raw_err = max(float((y6 - ry6).abs().max()), float((h6 - rh6).abs().max()))
    check(torch.allclose(y6, ry6, **SSD_TOL) and torch.allclose(h6, rh6, **SSD_TOL),
          f"ssd_scan (f32, not bf16 values) within {SSD_TOL} of its plain version "
          f"({f32_raw_err})")
    del raw, y6, h6, ry6, rh6
    # the function's least work, at the kernel's 64-row chunks: C.B^T once per
    # batch row and chunk (one group: every head shares it), then per head
    # G.x, C.h and the state update, causal halves only.  bf16 products are
    # exact on the tensor cores; the per-head products take an f32 factor
    # (decay weights, the state), split into bf16 hi + lo: two products each.
    qc = 64
    tri = qc * (qc + 1) // 2
    mac = b * (l // qc) * (tri * n + nh * 2 * (tri * p + 2 * qc * p * n))
    bound_ms, bound_by = bound(
        sum(t.numel() * t.element_size() for t in inputs) + ybf.numel() * 2 + hbf.numel() * 4,
        2 * mac, BF16_FLOPS_PER_S)
    out.append({
        "name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:93",
        "launches": launches["ssd_scan"], "max_abs_err": err,
        "launches_per_call": by_run["mamba2-1.3b"]["ssd_scan"],
        "per_call_of": f"mamba2-1.3b prefill ({SERVE_MAMBA2_LAYERS} layers)",
        "launches_by_run": {run: n["ssd_scan"] for run, n in by_run.items() if n.get("ssd_scan")},
        "f32_not_bf16_max_abs_err": f32_raw_err,
        "tolerance": f"f32 on upcast inputs, allclose {SSD_TOL}; bf16 in/out: y allclose "
                     f"{BF16_TOL}, state allclose {SSD_TOL}",
        **kernel_times(lambda: ss.ssd_scan(*inputs, chunk=256)),
        "plain_ms": cuda_ms(lambda: ss.ssd_chunked(*inputs, chunk=256)),
        "ms_f32": cuda_ms(lambda: ss.ssd_scan(*up, chunk=256)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "library": "none: no single PyTorch call computes it",
        "bf16_max_abs_err_vs_f32_plain": bf16_err,
        "bf16_state_max_abs_err_vs_f32_plain": bf16_state_err,
        "y_max_abs": float(ry.abs().max()), "y_mean_abs": float(ry.abs().mean()),
        "shape_x": [b, l, nh, p], "state": n,
    })
    del inputs, up, y32, h32, ry, rh, ybf, hbf
    # one jamba-v0.1-52b prefill layer: 128 heads, state 16 (the kernel pads
    # the state to its 128 columns)
    nh, n = 128, 16
    x = normal(b, l, nh, p)
    dt = (torch.rand((b, l, nh), generator=gen, device=dev) * 0.8 + 0.1).to(torch.bfloat16)
    a = (-(torch.rand((nh,), generator=gen, device=dev) + 0.5)).to(torch.bfloat16)
    inputs = (x, dt, a, normal(b, l, n), normal(b, l, n))
    up = tuple(t.float() for t in inputs)
    y32, h32 = ss.ssd_scan(*up, chunk=256)
    ry, rh = ss.ssd_chunked(*up, chunk=256)
    err32 = max(float((y32 - ry).abs().max()), float((h32 - rh).abs().max()))
    check(torch.allclose(y32, ry, **SSD_TOL) and torch.allclose(h32, rh, **SSD_TOL),
          f"ssd_scan at jamba's layer (f32) within {SSD_TOL} of its plain version ({err32})")
    ybf, hbf = ss.ssd_scan(*inputs, chunk=256)
    bf16_err = float((ybf.float() - ry).abs().max())
    bf16_state_err = float((hbf - rh).abs().max())
    check(torch.allclose(ybf.float(), ry, **BF16_TOL) and torch.allclose(hbf, rh, **SSD_TOL),
          f"ssd_scan at jamba's layer (bf16 in) y within {BF16_TOL} ({bf16_err}), the state "
          f"within {SSD_TOL} ({bf16_state_err}) of the f32 plain version")
    mac = b * (l // qc) * (tri * n + nh * 2 * (tri * p + 2 * qc * p * n))
    jamba_bound_ms, jamba_bound_by = bound(
        sum(t.numel() * t.element_size() for t in inputs) + ybf.numel() * 2 + hbf.numel() * 4,
        2 * mac, BF16_FLOPS_PER_S)
    out[-1]["jamba_case"] = {
        "shape_x": [b, l, nh, p], "state": n, "max_abs_err": err32,
        "bf16_max_abs_err_vs_f32_plain": bf16_err,
        "bf16_state_max_abs_err_vs_f32_plain": bf16_state_err,
        **kernel_times(lambda: ss.ssd_scan(*inputs, chunk=256)),
        "plain_ms": cuda_ms(lambda: ss.ssd_chunked(*inputs, chunk=256)),
        "ms_f32": cuda_ms(lambda: ss.ssd_scan(*up, chunk=256)),
        "bound_ms": jamba_bound_ms, "bound_by": jamba_bound_by,
    }
    del inputs, up, y32, h32, ry, rh, ybf, hbf
    out[-1]["tensor_parallel_cases"] = ssd_tensor_parallel_cases(normal, gen)
    out[-1]["long_decode_cases"] = ssd_tensor_parallel_cases(normal, gen, LD_SSD_SHAPES)

    # ---- partition_histogram: one partition of the value-histogram path ----
    st = x_values
    got = pr.partition_histogram(st, bins=VALUE_BINS)
    want = pr.partition_histogram_ref(st, bins=VALUE_BINS)
    check(torch.equal(got, want), "partition_histogram equals its plain version bit for bit")
    check(torch.equal(pr.partition_histogram(st, bins=VALUE_BINS), got),
          "partition_histogram gives the same bits on a second launch")
    histc = lambda: torch.histc(st, bins=VALUE_BINS, min=0.0, max=1.0)  # noqa: E731
    histc_diff = float((histc() - got).abs().max())
    nelem = st.numel()
    # per value: the guess (a subtract, a multiply, two clamps) and the four
    # edge comparisons that close both walks
    bound_ms, bound_by = bound(nelem * 4 + VALUE_BINS * 4, 8 * nelem)
    out.append({
        "name": "partition_histogram", "route": "cuda",
        "source": "src/repro_torch/csrc/partition_histogram.cu",
        "replaces": "src/repro/kernels/partition_reduce.py:84",
        "launches": launches["partition_histogram"],
        "launches_per_call": launches["partition_histogram"],
        "per_call_of": f"value histogram over {LOCATIONS} partitions",
        "max_abs_err": float((got - want).abs().max()), "tolerance": "bit-exact",
        **kernel_times(lambda: pr.partition_histogram(st, bins=VALUE_BINS)),
        "plain_ms": cuda_ms(lambda: pr.partition_histogram_ref(st, bins=VALUE_BINS)),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": cuda_ms(histc),
        "library": "torch.histc(bins=128, min=0, max=1), a yardstick only: not the same "
                   "function (it drops values outside [min, max] where the kernel clamps "
                   "them into the end bins, and rounds its edges its own way)",
        "library_max_abs_diff": histc_diff,
        "shape": list(st.shape), "bins": VALUE_BINS,
    })
    return out


STRUCTURAL = ("dispatches", "merges", "traces", "bytes_moved", "granularity")


def _structural(report) -> tuple:
    return tuple(getattr(report, f) for f in STRUCTURAL)


def threaded_phase(x_hist, x_km, seed: int, repeats: int) -> dict:
    """Histogram and k-means on a ThreadedExecutor beside a LocalExecutor,
    barriered and (k-means) pipelined, on the main path's data."""
    from repro_torch.api import Collection, SplIter, engine
    from repro_torch.core.apps.histogram import histogram
    from repro_torch.core.apps.kmeans import _combine, kmeans, partial_sum_block
    from repro_torch.kernels import partition_reduce as pr

    runs = {  # name: (app, policy, pipelined)
        "histogram/spliter1_pallas": ("histogram", SplIter(1, fusion="pallas"), False),
        "histogram/spliter2": ("histogram", SplIter(2), False),
        "kmeans/spliter1_pallas": ("kmeans", SplIter(1, fusion="pallas"), False),
        "kmeans/spliter1_pallas/pipeline": ("kmeans", SplIter(1, fusion="pallas"), True),
    }
    out = {}
    for name, (app, pol, pipelined) in runs.items():
        got = {}
        for backend in ("local", "threaded"):
            counter = pr.partition_histogramdd if app == "histogram" else pr.partition_kmeans
            ex = engine(backend)
            walls, launches = [], []
            for _ in range(1 + repeats):  # one warm-up, then timed runs
                torch.cuda.synchronize()
                c0, t0 = counter.launches, time.perf_counter()
                if app == "histogram":
                    value, rep = histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex)
                    reports = [rep]
                else:
                    res = kmeans(x_km, k=KM_K, iters=KM_ITERS, seed=seed, policy=pol,
                                 executor=ex, pipeline=pipelined)
                    value, reports = res.centers, res.reports
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                launches.append(counter.launches - c0)
            counts = None
            if app == "kmeans":
                counts = (Collection.from_blocked(x_km).split(pol)
                          .map_blocks(partial_sum_block, extra_args=(value,))
                          .reduce(_combine).compute(executor=ex).value[1])
            threads = [w._thread for w in getattr(ex, "_workers", {}).values()]
            ex.close()
            got[backend] = {
                "value": value, "counts": counts, "reports": reports, "launches": launches,
                "wall_s": statistics.median(walls[1:]), "threads": threads,
                "joined": not any(t.is_alive() for t in threads),
            }
        loc, thr = got["local"], got["threaded"]
        per_call = LOCATIONS * pol.partitions_per_location * (KM_ITERS if app == "kmeans" else 1)
        overlapped = [r.overlapped_launches for r in thr["reports"]]
        result = {
            "phase": "threaded", "run": name, "policy": repr(pol), "pipeline": pipelined,
            "local_wall_s": loc["wall_s"], "threaded_wall_s": thr["wall_s"],
            "launches_per_call": thr["launches"][-1], "worker_threads": len(thr["threads"]),
            "dispatches": sum(r.dispatches for r in thr["reports"]),
            "overlapped_launches": overlapped,
        }
        emit(result)
        check(torch.equal(loc["value"], thr["value"]),
              f"threaded {name}: the value equals the LocalExecutor's bit for bit")
        if counts is not None:
            check(torch.equal(loc["counts"], thr["counts"]), f"threaded {name}: counts equal")
        check([_structural(r) for r in loc["reports"]] == [_structural(r) for r in thr["reports"]],
              f"threaded {name}: dispatches, merges, traces, bytes_moved and granularity equal")
        check(set(loc["launches"]) == set(thr["launches"]) == {per_call},
              f"threaded {name}: {per_call} kernel launches per call: "
              f"{loc['launches']} / {thr['launches']}")
        check(len(thr["threads"]) == LOCATIONS and thr["joined"],
              f"threaded {name}: {LOCATIONS} worker threads, all joined after close()")
        if pipelined:
            check(overlapped[0] == 0 and sum(overlapped[1:]) > 0,
                  f"threaded {name}: iterations 2-{KM_ITERS} overlapped ({overlapped})")
        out[name] = result
    return out


#: the stream phase cuts k-means from KM_ITERS to 3 iterations for the time
#: limit; each histogram store takes one cold pass and this many warm ones
STREAM_KM_ITERS, STREAM_WARM_PASSES = 3, 3
#: device memory the stream phase may take beyond 1.25 x the budget and one
#: partition (k-means's stacked operand): a loaded chunk not yet inserted, a
#: chunk waiting for its spill write, the apps' small tensors
STREAM_SLACK_BYTES = 16 * 2**20


def _stream_memory(base: int, budget: int, partition: int, what: str) -> dict:
    """The device memory a stream run took beyond ``base``, against its bound."""
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    terms = {"peak_rise": rise, "budget_x1_25": 1.25 * budget, "partition": partition,
             "slack": STREAM_SLACK_BYTES, "limit": 1.25 * budget + partition + STREAM_SLACK_BYTES}
    check(rise <= terms["limit"], f"stream {what}: device memory rose {rise} B, more than "
          f"1.25 x budget + a partition + 16 MiB = {terms['limit']} B")
    return terms


def _io_of(reports) -> dict:
    loaded = sum(r.bytes_loaded for r in reports)
    return {"bytes_loaded": loaded, "bytes_spilled": sum(r.bytes_spilled for r in reports),
            "prefetch_hits": sum(r.prefetch_hits for r in reports)}


def stream_phase(x_hist, x_km, seed: int, repeats: int) -> dict:
    """Both apps streamed from disk through a ``DiskStore`` on the card whose
    budget is a quarter of the data, on a ``StreamExecutor`` with
    ``prefetch_depth`` 1 and 0, against a ``LocalExecutor`` on the in-memory
    data.  Returns the kernel launches of the StreamExecutor runs."""
    from repro_torch.api import Collection, DiskStore, SplIter, engine
    from repro_torch.core.apps.histogram import histogram
    from repro_torch.core.apps.kmeans import _combine, kmeans, partial_sum_block
    from repro_torch.kernels import partition_reduce as pr

    dev = x_hist.device
    hist_budget, km_budget = x_hist.nbytes // 4, x_km.nbytes // 4
    hist_partition = BLOCKS_PER_LOCATION * BLOCK_ROWS * HIST_D * 4
    km_partition = BLOCKS_PER_LOCATION * BLOCK_ROWS * KM_D * 4
    hist_pols = {"spliter1_pallas": SplIter(1, fusion="pallas"), "spliter2": SplIter(2)}
    km_pol = SplIter(1, fusion="pallas")
    launched = {"partition_histogramdd": 0, "partition_kmeans": 0}

    def timed(fn):
        torch.cuda.synchronize()
        h0, k0, t0 = pr.partition_histogramdd.launches, pr.partition_kmeans.launches, \
            time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, (pr.partition_histogramdd.launches - h0,
                                               pr.partition_kmeans.launches - k0)

    def km_counts(x, centers, ex):
        return (Collection.from_blocked(x).split(km_pol)
                .map_blocks(partial_sum_block, extra_args=(centers,))
                .reduce(_combine).compute(executor=ex).value[1])

    # -- the LocalExecutor on the in-memory data: values, reports, walls ----
    local = {}
    for name, pol in hist_pols.items():
        with engine("local") as ex:
            runs = [timed(lambda: histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex))
                    for _ in range(1 + STREAM_WARM_PASSES)]
        local[name] = {"value": runs[0][0][0], "cold": runs[0][0][1], "warm": runs[-1][0][1],
                       "wall_s": statistics.median(w for _, w, _ in runs[1:])}
    with engine("local") as ex:
        for pipelined in (False, True):
            runs = [timed(lambda: kmeans(x_km, k=KM_K, iters=STREAM_KM_ITERS, seed=seed,
                                         policy=km_pol, executor=ex, pipeline=pipelined))
                    for _ in range(1 + repeats)]
            res = runs[0][0]
            local[("kmeans", pipelined)] = {
                "value": res.centers, "reports": res.reports,
                "counts": km_counts(x_km, res.centers, ex),
                "wall_s": statistics.median(w for _, w, _ in runs[1:])}

    out = {}
    for depth in (1, 0):
        # -- histogram: a fresh store per policy, one cold and three warm passes
        for name, pol in hist_pols.items():
            gc.collect()  # earlier passes' cycles (see _peak_rise)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            store = DiskStore(residency_bytes=hist_budget, device=dev)
            xd, ingest_s, _ = timed(lambda: x_hist.to_store(store))
            ex = engine("stream", prefetch_depth=depth)
            passes = []
            for i in range(1 + STREAM_WARM_PASSES):
                (h, rep), wall, (nh, _) = timed(
                    lambda: histogram(xd, bins=HIST_BINS, policy=pol, executor=ex))
                launched["partition_histogramdd"] += nh
                ref = local[name]
                check(torch.equal(h, ref["value"]),
                      f"stream histogram/{name} depth {depth} pass {i}: counts equal Local's")
                check(_structural(rep) == _structural(ref["cold" if i == 0 else "warm"]),
                      f"stream histogram/{name} depth {depth} pass {i}: dispatches, merges, "
                      f"traces, bytes_moved and granularity equal Local's")
                check(nh == LOCATIONS * pol.partitions_per_location,
                      f"stream histogram/{name}: one kernel launch per partition ({nh})")
                passes.append({"pass": "cold" if i == 0 else "warm", "wall_s": wall,
                               "launches": nh, **_io_of([rep]),
                               "load_gb_per_s": rep.bytes_loaded / wall / 1e9})
            spill_dir = store.spill_dir
            ex.close()
            memory = _stream_memory(base, hist_budget, hist_partition, f"histogram/{name}")
            result = {
                "phase": "stream", "run": f"histogram/{name}", "policy": repr(pol),
                "prefetch_depth": depth, "data_bytes": x_hist.nbytes, "budget": hist_budget,
                "ingest_s": ingest_s, "passes": passes,
                "warm_wall_s": statistics.median(p["wall_s"] for p in passes[1:]),
                "local_wall_s": local[name]["wall_s"],
                "gb_loaded": sum(p["bytes_loaded"] for p in passes) / 1e9,
                "gb_spilled": store.stats.bytes_spilled / 1e9,
                "peak_resident_bytes": store.stats.peak_resident_bytes,
                "peak_resident_limit": 1.25 * hist_budget, "device_memory": memory,
                "store_closed": store.closed, "spill_dir_removed": not os.path.exists(spill_dir),
            }
            emit(result)
            check(passes[0]["bytes_spilled"] > 0, f"stream {result['run']}: the cold pass spilled")
            check(all(p["bytes_loaded"] > 0 for p in passes),
                  f"stream {result['run']}: every pass loaded")
            check(all((p["prefetch_hits"] > 0) == (depth > 0) for p in passes),
                  f"stream {result['run']} depth {depth}: prefetch hits iff prefetching")
            check(store.stats.peak_resident_bytes <= 1.25 * hist_budget,
                  f"stream {result['run']}: peak resident {store.stats.peak_resident_bytes} B "
                  f"within 1.25 x the budget")
            check(result["store_closed"] and result["spill_dir_removed"],
                  f"stream {result['run']}: close() removed the spill directory")
            out[(result["run"], depth)] = result

        # -- k-means: one store, barriered (its first iteration is the cold
        # pass), then pipelined
        gc.collect()  # earlier passes' cycles (see _peak_rise)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        store = DiskStore(residency_bytes=km_budget, device=dev)
        xd, ingest_s, _ = timed(lambda: x_km.to_store(store))
        ex = engine("stream", prefetch_depth=depth)
        runs = []
        for pipelined in (False, True):
            loaded0 = store.stats.bytes_loaded
            res, wall, (_, nk) = timed(lambda: kmeans(
                xd, k=KM_K, iters=STREAM_KM_ITERS, seed=seed, policy=km_pol, executor=ex,
                pipeline=pipelined))
            loaded = store.stats.bytes_loaded - loaded0  # this run's reads, exactly
            counts, _, (_, nk_counts) = timed(lambda: km_counts(xd, res.centers, ex))
            launched["partition_kmeans"] += nk + nk_counts
            ref = local[("kmeans", pipelined)]
            name = f"kmeans/spliter1_pallas{'/pipeline' if pipelined else ''}"
            check(torch.equal(res.centers, ref["value"]),
                  f"stream {name} depth {depth}: centers equal Local's bit for bit")
            check(torch.equal(counts, ref["counts"]), f"stream {name} depth {depth}: counts equal")
            check([_structural(r) for r in res.reports] == [_structural(r) for r in ref["reports"]],
                  f"stream {name} depth {depth}: dispatches, merges, traces, bytes_moved and "
                  f"granularity equal Local's")
            check(nk == LOCATIONS * STREAM_KM_ITERS,
                  f"stream {name}: one kernel launch per partition and iteration ({nk})")
            overlapped = [r.overlapped_launches for r in res.reports]
            if pipelined:
                check(overlapped[0] == 0 and all(n > 0 for n in overlapped[1:]),
                      f"stream {name} depth {depth}: iterations 2-{STREAM_KM_ITERS} "
                      f"overlapped ({overlapped})")
            io = _io_of(res.reports)
            check(io["bytes_loaded"] > 0 and (io["prefetch_hits"] > 0) == (depth > 0),
                  f"stream {name} depth {depth}: loads, and prefetch hits iff prefetching ({io})")
            if not pipelined:
                check(io["bytes_spilled"] > 0, f"stream {name}: the cold run spilled")
            # A pipelined entry's report bills the store's counters from its
            # drain's start to its finalization, which can follow the next
            # entry's drain (as in the JAX package): the reports' sum then
            # counts an iteration twice.  The rate uses the store's counters.
            runs.append({"run": name, "wall_s": wall, "local_wall_s": ref["wall_s"],
                         "iterations": STREAM_KM_ITERS, "launches": nk,
                         "overlapped_launches": overlapped, "reports": io,
                         "store_bytes_loaded": loaded, "load_gb_per_s": loaded / wall / 1e9})
        spill_dir = store.spill_dir
        ex.close()
        memory = _stream_memory(base, km_budget, km_partition, "kmeans")
        result = {
            "phase": "stream", "run": "kmeans/spliter1_pallas", "policy": repr(km_pol),
            "prefetch_depth": depth, "data_bytes": x_km.nbytes, "budget": km_budget,
            "iterations": f"{STREAM_KM_ITERS} (cut from {KM_ITERS} for the time limit)",
            "ingest_s": ingest_s, "runs": runs,
            "gb_loaded": store.stats.bytes_loaded / 1e9,
            "gb_spilled": store.stats.bytes_spilled / 1e9,
            "peak_resident_bytes": store.stats.peak_resident_bytes,
            "peak_resident_limit": 1.25 * km_budget, "device_memory": memory,
            "store_closed": store.closed, "spill_dir_removed": not os.path.exists(spill_dir),
        }
        emit(result)
        check(store.stats.peak_resident_bytes <= 1.25 * km_budget,
              f"stream kmeans: peak resident {store.stats.peak_resident_bytes} B within "
              f"1.25 x the budget")
        check(result["store_closed"] and result["spill_dir_removed"],
              "stream kmeans: close() removed the spill directory")
        out[(result["run"], depth)] = result

    # -- the pin hooks on a threaded backend: one pass over a DiskStore copy
    store = DiskStore(residency_bytes=hist_budget, device=dev)
    xd = x_hist.to_store(store)
    with engine("threaded") as ex:
        (h, rep), wall, _ = timed(lambda: histogram(xd, bins=HIST_BINS,
                                                    policy=hist_pols["spliter1_pallas"],
                                                    executor=ex))
    spill_dir = store.spill_dir
    store.close()
    emit({"phase": "stream", "run": "histogram/spliter1_pallas/threaded", "wall_s": wall,
          **_io_of([rep]), "spill_dir_removed": not os.path.exists(spill_dir)})
    check(torch.equal(h, local["spliter1_pallas"]["value"]),
          "stream threaded histogram over a DiskStore equals Local's")
    check(_structural(rep) == _structural(local["spliter1_pallas"]["cold"]),
          "stream threaded histogram: structural columns equal Local's")
    check(rep.bytes_loaded > 0 and not os.path.exists(spill_dir),
          "stream threaded histogram loaded from disk, and its spill directory is gone")
    emit({"phase": "stream", "stream_launches": launched})
    check(all(n > 0 for n in launched.values()),
          f"both partition kernels launched through the stream path: {launched}")
    return launched


#: the mesh phase's ranks: one card as one rank, and as eight (the JAX
#: package's tests force 8 host devices; here eight ranks share cuda:0)
MESH_RANKS = (1, 8)
#: how far a mesh pass may raise device memory above Local's same pass: the
#: rank partials and their gathered copies (8 x 131,072 B for the histogram)
MESH_MEMORY_SLACK = 4 * 2**20
#: the reference's mesh tolerance for k-means centers (tests/test_api.py:427)
MESH_TOL = dict(rtol=2e-4, atol=2e-4)


def value_histogram_block(block, *, bins: int, lo: float, hi: float):
    """The value histogram of one block: the plain fold the registry's
    ``partition_histogram`` kernel replaces on the mesh phase's run."""
    from repro_torch.kernels.ref import histogram_ref

    return histogram_ref(block, bins=bins, lo=lo, hi=hi)


def _value_histogram_kernel(args: tuple, kwargs: dict):
    from repro_torch.api.kernels import PartitionKernel
    from repro_torch.kernels.partition_reduce import partition_histogram

    if args or set(kwargs) != {"bins", "lo", "hi"}:
        return None
    bins, lo, hi = kwargs["bins"], kwargs["lo"], kwargs["hi"]
    return PartitionKernel(
        name="partition_histogram", key=("value_hist", bins, lo, hi),
        # the kernel takes the stacked partition, as the value histogram
        # phase passes it: a copy of the partition's blocks per launch
        fn=lambda blocks: partition_histogram(torch.stack(list(blocks)), bins=bins, lo=lo,
                                              hi=hi),
        supports=lambda stacked_shape, extra_args: not extra_args)


def _fold_tree(groups) -> tuple:
    """The association of a fold: each group chained left to right, then
    the groups' values chained in group order."""
    def chain(xs):
        xs = list(xs)
        acc = xs[0]
        for x in xs[1:]:
            acc = (acc, x)
        return acc

    return chain(chain(g) for g in groups)


def same_association(locations: list[int], ranks: int) -> bool:
    """Whether the mesh folds one run of task partials (at ``locations``, in
    plan order) as LocalExecutor's merge does: Local chains each location's
    partials, then the locations (``fold_plan``); the mesh chains each
    rank's contiguous share, then the ranks.  Where the two trees agree,
    float partials give the same bits."""
    from repro_torch.api import MeshExecutor
    from repro_torch.api.lowering import fold_plan

    local = _fold_tree(m for _, m in fold_plan(enumerate(locations)))
    n = len(locations)
    m = MeshExecutor._axis_size(n, ranks)
    share = n // m
    return local == _fold_tree(range(r * share, (r + 1) * share) for r in range(m))


def _peak_rise(run) -> tuple:
    """``run()``'s result and how far it raised the allocated device memory.

    An executor's pass leaves reference cycles that hold its tensors, so an
    earlier pass's garbage is collected first: freed during ``run()``, it
    would offset the rise being measured.
    """
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = run()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def mesh_phase(x_hist, x_km, seed: int, repeats: int) -> dict:
    """Both apps on ``engine("mesh")`` at one and eight ranks on the card,
    beside a LocalExecutor on the same data; the value histogram once on the
    mesh through the registry.  Returns the kernel launches of the mesh runs."""
    import functools

    from repro_torch.api import (Baseline, Collection, Rechunk, SplIter, engine,
                                 register_partition_kernel)
    from repro_torch.core.apps.histogram import histogram, histogramdd_block
    from repro_torch.core.apps.kmeans import _combine, kmeans, partial_sum_block
    from repro_torch.kernels import partition_reduce as pr
    from repro_torch.kernels.ref import histogram_ref

    dev = x_hist.device
    hist_fn = functools.partial(histogramdd_block, bins=HIST_BINS, lo=0.0, hi=1.0)
    reset_launches()  # the phase's launches: counted from 0, read at its end
    launched = {"partition_histogram": 0, "partition_histogramdd": 0, "partition_kmeans": 0}
    hist_partial = HIST_BINS**HIST_D * 4
    km_partial = (KM_K * KM_D + KM_K) * 4
    policies = {"baseline": Baseline(), "spliter1_scan": SplIter(1, fusion="scan"),
                "spliter1_pallas": SplIter(1, fusion="pallas"), "spliter2": SplIter(2),
                "rechunk": Rechunk()}

    def hist_runs(ex, pol):
        runs = []
        for i in range(1 + repeats):  # one warm-up, then timed passes
            def one():
                torch.cuda.synchronize()
                c0, t0 = pr.partition_histogramdd.launches, time.perf_counter()
                h, rep = histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex)
                torch.cuda.synchronize()
                return h, rep, time.perf_counter() - t0, pr.partition_histogramdd.launches - c0
            out, rise = _peak_rise(one)
            runs.append((*out, rise))
        return runs

    def km_runs(ex, pol):
        runs = []
        for _ in range(1 + repeats):
            def one():
                torch.cuda.synchronize()
                c0, t0 = pr.partition_kmeans.launches, time.perf_counter()
                res = kmeans(x_km, k=KM_K, iters=KM_ITERS, seed=seed, policy=pol, executor=ex)
                torch.cuda.synchronize()
                return res, time.perf_counter() - t0, pr.partition_kmeans.launches - c0
            out, rise = _peak_rise(one)
            runs.append((*out, rise))
        c0 = pr.partition_kmeans.launches
        counts = (Collection.from_blocked(x_km).split(pol)
                  .map_blocks(partial_sum_block, extra_args=(runs[-1][0].centers,))
                  .reduce(_combine).compute(executor=ex).value[1])
        return runs, counts, pr.partition_kmeans.launches - c0

    # one executor per backend for the whole phase; each policy runs on Local
    # and then on each mesh back to back, so that the walls compare within
    # a few seconds of each other
    km_pol = SplIter(1, fusion="pallas")
    executors = {"local": engine("local")}
    executors.update({ranks: engine("mesh", devices=(dev,) * ranks) for ranks in MESH_RANKS})
    hist = {name: {k: hist_runs(ex, pol) for k, ex in executors.items()}
            for name, pol in policies.items()}
    kms = {k: km_runs(ex, km_pol) for k, ex in executors.items()}
    # each plan's task locations, in plan order: what decides the fold's association
    lower = executors["local"].lower
    locations = {name: [t.location for t in lower(
        Collection.from_blocked(x_hist).split(pol).map_blocks(hist_fn)
        .reduce(torch.add).plan()).tasks] for name, pol in policies.items()}
    local_km, local_counts, _ = kms["local"]
    km_locations = [t.location for t in lower(
        Collection.from_blocked(x_km).split(km_pol)
        .map_blocks(partial_sum_block, extra_args=(local_km[0][0].centers,))
        .reduce(_combine).plan()).tasks]
    for ex in executors.values():
        ex.close()

    for ranks in MESH_RANKS:
        devices = (dev,) * ranks
        rows = []
        for name, pol in policies.items():
            runs, ref = hist[name][ranks], hist[name]["local"]
            launched["partition_histogramdd"] += sum(r[3] for r in runs)
            same = same_association(locations[name], ranks)
            row = {"policy": name, "tasks": len(locations[name]),
                   "same_association_as_local": same,
                   "dispatches": [r[1].dispatches for r in runs],
                   "local_dispatches": ref[-1][1].dispatches,
                   "merges": runs[-1][1].merges, "traces": runs[0][1].traces,
                   "bytes_moved": [r[1].bytes_moved for r in runs],
                   "launches_per_pass": runs[-1][3], "local_launches_per_pass": ref[-1][3],
                   "wall_s": statistics.median(r[2] for r in runs[1:]),
                   "local_wall_s": statistics.median(r[2] for r in ref[1:]),
                   "peak_memory_rise": runs[-1][4], "local_peak_memory_rise": ref[-1][4]}
            rows.append(row)
            what = f"mesh {ranks} rank(s) histogram/{name}"
            check(all(torch.equal(r[0], q[0]) for r, q in zip(runs, ref)),
                  f"{what}: counts equal Local's")
            if isinstance(pol, SplIter):
                check(all(r[1].dispatches == 1 for r in runs),
                      f"{what}: one sharded dispatch per pass ({row['dispatches']})")
            moved = (ranks - 1) * hist_partial if ranks > 1 else 0
            check(all(r[1].merges == (1 if ranks > 1 else 0)
                      and r[1].bytes_moved == q[1].bytes_moved + moved
                      and r[1].granularity == q[1].granularity for r, q in zip(runs, ref)),
                  f"{what}: merges {int(ranks > 1)} and bytes_moved Local's + {moved} B "
                  f"({[(r[1].merges, r[1].bytes_moved) for r in runs]})")
            check([r[3] for r in runs] == [q[3] for q in ref],
                  f"{what}: kernel launches per pass equal Local's "
                  f"({[r[3] for r in runs]} / {[q[3] for q in ref]})")
            check(runs[-1][4] <= ref[-1][4] + MESH_MEMORY_SLACK,
                  f"{what}: device memory rose {runs[-1][4]} B in a pass, Local's "
                  f"{ref[-1][4]} B + {MESH_MEMORY_SLACK} B at most (no group-axis copy)")

        runs, counts, counts_launches = kms[ranks]
        launched["partition_kmeans"] += sum(r[2] for r in runs) + counts_launches
        same = same_association(km_locations, ranks)
        km = runs[-1][0]
        row = {"policy": "kmeans/spliter1_pallas", "iterations": KM_ITERS,
               "same_association_as_local": same,
               "dispatches": [r.dispatches for r in km.reports],
               "merges": [r.merges for r in km.reports],
               "bytes_moved": [r.bytes_moved for r in km.reports],
               "launches_per_run": runs[-1][2], "local_launches_per_run": local_km[-1][2],
               "wall_s": statistics.median(r[1] for r in runs[1:]),
               "local_wall_s": statistics.median(r[1] for r in local_km[1:]),
               "peak_memory_rise": runs[-1][3], "local_peak_memory_rise": local_km[-1][3],
               "max_center_diff": float((km.centers - local_km[-1][0].centers).abs().max())}
        rows.append(row)
        what = f"mesh {ranks} rank(s) kmeans"
        check(torch.equal(counts, local_counts), f"{what}: counts equal Local's")
        for r, q in zip(runs, local_km):
            if same:
                check(torch.equal(r[0].centers, q[0].centers),
                      f"{what}: centers bit-identical to Local's (same association)")
            else:
                check(torch.allclose(r[0].centers, q[0].centers, **MESH_TOL),
                      f"{what}: centers within 2e-4 of Local's")
        moved = (ranks - 1) * km_partial if ranks > 1 else 0
        check(all([x.dispatches for x in r[0].reports] == [1] * KM_ITERS
                  and all(x.merges == int(ranks > 1) and x.bytes_moved == moved
                          for x in r[0].reports) for r in runs),
              f"{what}: one sharded dispatch per iteration, merges {int(ranks > 1)} and "
              f"{moved} B moved per iteration")
        check([r[2] for r in runs] == [q[2] for q in local_km] == [KM_ITERS * LOCATIONS] *
              len(runs), f"{what}: {KM_ITERS * LOCATIONS} kernel launches per run, as Local")
        check(runs[-1][3] <= local_km[-1][3] + MESH_MEMORY_SLACK,
              f"{what}: device memory rose {runs[-1][3]} B in a run, Local's "
              f"{local_km[-1][3]} B + {MESH_MEMORY_SLACK} B at most")
        emit({"phase": "mesh", "ranks": ranks, "devices": [str(d) for d in devices],
              "rows": rows})

    # the value histogram once on the mesh, its kernel reached through the registry
    register_partition_kernel(value_histogram_block, _value_histogram_kernel)
    fn = functools.partial(value_histogram_block, bins=VALUE_BINS, lo=0.0, hi=1.0)
    with engine("mesh", devices=(dev,) * LOCATIONS) as ex:
        torch.cuda.synchronize()
        c0, t0 = pr.partition_histogram.launches, time.perf_counter()
        res = (Collection.from_blocked(x_hist).split(SplIter(1, fusion="pallas"))
               .map_blocks(fn).reduce(torch.add).compute(executor=ex))
        torch.cuda.synchronize()
        wall, n = time.perf_counter() - t0, pr.partition_histogram.launches - c0
    launched["partition_histogram"] += n
    want = histogram_ref(x_hist.collect(), bins=VALUE_BINS, lo=0.0, hi=1.0)
    emit({"phase": "mesh", "run": "value_histogram", "ranks": LOCATIONS, "bins": VALUE_BINS,
          "wall_s": wall, "launches": n, "dispatches": res.report.dispatches,
          "bytes_moved": res.report.bytes_moved})
    check(n == LOCATIONS, f"mesh value histogram: one partition_histogram launch a partition ({n})")
    check(torch.equal(res.value, want), "mesh value histogram equals histogram_ref bit for bit")
    check(res.report.bytes_moved == (LOCATIONS - 1) * VALUE_BINS * 4,
          "mesh value histogram: (8 - 1) partials of 128 f32 moved")
    emit({"phase": "mesh", "mesh_launches": launched})
    # the counters, set to 0 at the phase's start, hold the mesh runs'
    # launches and those of the Local runs beside them
    local = {"partition_histogram": 0,
             "partition_histogramdd": sum(r[3] for runs in hist.values() for r in runs["local"]),
             "partition_kmeans": sum(r[2] for r in kms["local"][0]) + kms["local"][2]}
    counts = read_launches()
    check(counts == {**{k: launched[k] + local[k] for k in launched}, "flash_attention": 0,
                     "ssd_scan": 0},
          f"mesh: the counters equal the mesh runs' and Local's launches ({counts})")
    return launched


#: room the cluster phase leaves in /dev/shm: its exports (both datasets in
#: one arena) may take at most half the free space, else rows are cut
CLUSTER_SHM_FACTOR = 2
#: the arena's budget above the exports: the k-means centers and slack
CLUSTER_SHM_SLACK = 64 * 2**20
#: the chaos round: ChaosSchedule(seed) over the 8 location owners — this
#: seed kills worker 4 on its 3rd dispatch, slows worker 1 by 0.02 s a unit,
#: and grows a roamer before round 2 and shrinks it before round 3
CLUSTER_CHAOS_SEED, CLUSTER_CHAOS_ROUNDS = 11, 3


def _worker_launches(ex) -> dict:
    """The partition kernels' launch counts summed over the live workers."""
    import functools

    from repro_torch.kernels import partition_reduce as pr

    return {name: sum(ex.call_workers(functools.partial(getattr, fn, "launches")).values())
            for name, fn in (("partition_histogramdd", pr.partition_histogramdd),
                             ("partition_kmeans", pr.partition_kmeans))}


def _worker_stats(ex) -> dict:
    """The workers' unit timings since the last read, summed (then zeroed)."""
    from repro_torch.api import cluster_worker

    per = ex.call_workers(cluster_worker.unit_stats, True)
    return {k: sum(v[k] for v in per.values())
            for k in ("units", "operands_s", "compute_s", "reply_s", "folds", "fold_s")}


def _processes_gone(pids) -> bool:
    return not any(os.path.exists(f"/proc/{pid}") for pid in pids)


def cluster_phase(x_hist, x_km, seed: int, repeats: int) -> dict:
    """Both apps on ``engine("cluster")``: one spawned worker per location,
    each computing on the card in its own CUDA context, operands over POSIX
    shared memory; beside a LocalExecutor.  Then a killed worker's replay and
    one ChaosSchedule.  Returns the kernel launches counted in the workers."""
    import functools

    from repro_torch.api import Baseline, ChaosSchedule, Collection, FaultPlan, SplIter, engine
    from repro_torch.api.shm import leaked_segments
    from repro_torch.core.apps.histogram import histogram, histogramdd_block
    from repro_torch.core.apps.kmeans import _combine, kmeans, partial_sum_block
    from repro_torch.core.blocked import BlockedArray, round_robin_placement
    from repro_torch.kernels import partition_reduce as pr

    dev = x_hist.device
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    export = x_hist.nbytes + x_km.nbytes
    rows = BLOCK_ROWS
    if free < CLUSTER_SHM_FACTOR * export:
        rows = max(1024, int(BLOCK_ROWS * free / (CLUSTER_SHM_FACTOR * export)) // 1024 * 1024)
        hist, km, _, _ = make_data(seed, dev, rows)
        x_hist, x_km = (
            BlockedArray.from_array(a, rows, num_locations=LOCATIONS,
                                    policy=round_robin_placement, device=dev)
            for a in (hist, km))
        del hist, km
        export = x_hist.nbytes + x_km.nbytes
    emit({"phase": "cluster", "run": "setup", "dev_shm_free_bytes": free,
          "export_bytes": export, "block_rows": rows,
          "rows_cut_from": BLOCK_ROWS if rows != BLOCK_ROWS else None,
          "workers": LOCATIONS, "heartbeat_timeout_s": 30.0})
    check(free >= CLUSTER_SHM_FACTOR * export, "/dev/shm holds twice the phase's exports")

    hist_partial = HIST_BINS**HIST_D * 4
    on_card = dev.type == "cuda"  # (a CPU rehearsal runs the plain versions: no launches)
    launched = {"partition_histogramdd": 0, "partition_kmeans": 0}
    local = engine("local")
    ex = engine("cluster", shm_budget_bytes=export + CLUSTER_SHM_SLACK)
    arena = ex._shm
    torch.cuda.synchronize()
    free_before_spawn = torch.cuda.mem_get_info(dev)[0]

    driver_launches = []  # the driver's own launches during each cluster run

    def timed(fn, cluster: bool = True):
        torch.cuda.synchronize()
        d0 = sum(read_launches().values())
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if cluster:
            driver_launches.append(sum(read_launches().values()) - d0)
        return out, wall

    def counted(fn):
        """``fn``'s value, wall, worker launches, bytes exported, export seconds."""
        c0, e0, s0 = _worker_launches(ex), arena.bytes_exported, arena.export_seconds
        out, wall = timed(fn)
        c1 = _worker_launches(ex)
        return (out, wall, {k: c1[k] - c0.get(k, 0) for k in c1},
                arena.bytes_exported - e0, arena.export_seconds - s0)

    rows_out = []
    policies = (("spliter1_pallas", SplIter(1, fusion="pallas")), ("baseline", Baseline()))
    for name, pol in policies:
        # Baseline's 16 partials a location clear the default p2p="auto" gate
        # once a pass of the same merge has shown their size (131,072 B): the
        # SplIter(1, pallas) passes before it have, so from its first pass one
        # fold unit a location folds them in its worker (DESIGN.md §16)
        runs, split = [], []
        for _ in range(1 + repeats):  # the first pass spawns and exports
            run = counted(lambda: histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex))
            runs.append(run)
            split.append(_worker_stats(ex))
        refs = [timed(lambda: histogram(x_hist, bins=HIST_BINS, policy=pol, executor=local),
                      cluster=False) for _ in range(1 + repeats)]
        ref, ref_rep = refs[-1][0]
        tasks = ref_rep.dispatches - ref_rep.merges
        folds = [LOCATIONS if name == "baseline" else 0] * (1 + repeats)
        per_pass = LOCATIONS * on_card if isinstance(pol, SplIter) else 0
        launched["partition_histogramdd"] += sum(r[2]["partition_histogramdd"] for r in runs)
        reps = [r[0][1] for r in runs]
        row = {"policy": name, "tasks": tasks,
               "dispatches": [r.dispatches for r in reps], "local_dispatches": ref_rep.dispatches,
               "merges": [r.merges for r in reps], "traces": reps[0].traces,
               "bytes_moved": [r.bytes_moved for r in reps],
               "remote_dispatches": [r.remote_dispatches for r in reps],
               "ipc_bytes": [r.ipc_bytes for r in reps], "shm_bytes": [r.shm_bytes for r in reps],
               "exported_bytes": [r[3] for r in runs], "retries": [r.retries for r in reps],
               "p2p_bytes": [r.p2p_bytes for r in reps],
               "driver_merge_bytes": [r.driver_merge_bytes for r in reps],
               "fold_units": [s["folds"] for s in split],
               "launches_per_pass": [r[2]["partition_histogramdd"] for r in runs],
               "first_pass_wall_s": runs[0][1],
               "wall_s": statistics.median(r[1] for r in runs[1:]),
               "local_wall_s": statistics.median(r[1] for r in refs[1:]),
               "export_s": runs[0][4],
               "split_s": [{**s, "export_s": r[4]} for s, r in zip(split, runs)]}
        rows_out.append(row)
        emit({"phase": "cluster", "run": f"histogram/{name}", **row})
        what = f"cluster histogram/{name}"
        check(all(torch.equal(r[0][0], ref) for r in runs), f"{what}: counts equal Local's")
        check(all(r.dispatches == ref_rep.dispatches + f and r.merges == ref_rep.merges + f
                  and r.bytes_moved == ref_rep.bytes_moved
                  and r.granularity == ref_rep.granularity for r, f in zip(reps, folds)),
              f"{what}: dispatches and merges equal Local's plus the fold units {folds}, "
              f"bytes moved and granularity equal Local's")
        check(all(r.remote_dispatches == tasks + f and r.retries == 0 and r.ipc_bytes > 0
                  for r, f in zip(reps, folds)),
              f"{what}: {tasks} remote dispatches a pass plus the fold units, no retries")
        first = x_hist.nbytes if name == policies[0][0] else 0
        check([r[3] for r in runs] == [first] + [0] * repeats,
              f"{what}: the dataset's {x_hist.nbytes} B exported on the first pass only "
              f"({[r[3] for r in runs]})")
        # published partials (N·S) and the folds' replies (L·S) in segments
        check(all(r.shm_bytes == e[3] + tasks * hist_partial + f * hist_partial
                  for r, e, f in zip(reps, runs, folds)),
              f"{what}: shm_bytes = the exports + {tasks} partials of {hist_partial} B "
              f"+ a fold's reply a fold unit")
        check([r.p2p_bytes for r in reps] == [tasks * hist_partial if f else 0 for f in folds]
              and [r.driver_merge_bytes for r in reps]
              == [f * hist_partial if f else tasks * hist_partial for f in folds],
              f"{what}: p2p_bytes N·S and driver_merge_bytes L·S on folded passes, "
              f"driver_merge_bytes N·S otherwise")
        check([s["folds"] for s in split] == folds,
              f"{what}: the fold units ran in the workers ({[s['folds'] for s in split]})")
        check([r[2]["partition_histogramdd"] for r in runs] == [per_pass] * (1 + repeats),
              f"{what}: {per_pass} partition_histogramdd launches a pass in the workers")

    # each kernel's worker result against its plain version on the card
    pol = SplIter(1, fusion="pallas")
    plain_hist = sum(pr.partition_histogramdd_ref([x_hist.block(b) for b in x_hist.blocks_at(loc)],
                                                  bins=HIST_BINS) for loc in range(LOCATIONS))
    c0 = _worker_launches(ex)
    (value, _), _ = timed(lambda: histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex))
    n = _worker_launches(ex)["partition_histogramdd"] - c0["partition_histogramdd"]
    launched["partition_histogramdd"] += n
    check(n == LOCATIONS * on_card and torch.equal(value, plain_hist),
          "cluster: the workers' partition_histogramdd partials sum to the plain version's")

    c0 = _worker_launches(ex)
    km, km_wall = timed(lambda: kmeans(x_km, k=KM_K, iters=KM_ITERS, seed=seed, policy=pol,
                                       executor=ex))
    km_split = _worker_stats(ex)
    km_launches = _worker_launches(ex)["partition_kmeans"] - c0["partition_kmeans"]
    km_ref, km_local_wall = timed(lambda: kmeans(x_km, k=KM_K, iters=KM_ITERS, seed=seed,
                                                 policy=pol, executor=local), cluster=False)
    centers = km_ref.centers
    plan = (Collection.from_blocked(x_km).split(pol)
            .map_blocks(partial_sum_block, extra_args=(centers,)).reduce(_combine))
    c0 = _worker_launches(ex)
    (sums, counts), _ = timed(lambda: plan.compute(executor=ex).value)
    km_launches_check = _worker_launches(ex)["partition_kmeans"] - c0["partition_kmeans"]
    lsums, lcounts = plan.compute(executor=local).value
    psums = torch.zeros_like(lsums)
    pcounts = torch.zeros_like(lcounts)
    for loc in range(LOCATIONS):
        st_ = torch.stack([x_km.block(b) for b in x_km.blocks_at(loc)])
        s_, c_ = pr.partition_kmeans_ref(st_, centers)
        psums += s_
        pcounts += c_
    del st_
    launched["partition_kmeans"] += km_launches + km_launches_check
    km_row = {"policy": "kmeans/spliter1_pallas", "iterations": KM_ITERS,
              "same_association_as_local": True,
              "dispatches": [r.dispatches for r in km.reports],
              "remote_dispatches": [r.remote_dispatches for r in km.reports],
              "ipc_bytes": [r.ipc_bytes for r in km.reports],
              "shm_bytes": [r.shm_bytes for r in km.reports],
              "retries": [r.retries for r in km.reports],
              "launches_per_run": km_launches, "wall_s": km_wall, "local_wall_s": km_local_wall,
              "iteration_wall_s": [r.wall_s for r in km.reports],
              "local_iteration_wall_s": [r.wall_s for r in km_ref.reports],
              "split_s": km_split, "max_center_diff": float((km.centers - centers).abs().max()),
              "partial_max_abs_err_vs_plain": float((sums - psums).abs().max())}
    emit({"phase": "cluster", "run": "kmeans", **km_row})
    check(torch.equal(km.centers, centers), "cluster kmeans: centers bit-identical to Local's "
          "(the driver folds the partials with Local's plan)")
    check([r.dispatches for r in km.reports] == [r.dispatches for r in km_ref.reports],
          "cluster kmeans: dispatches equal Local's")
    check(km_launches == KM_ITERS * LOCATIONS * on_card,
          f"cluster kmeans: {KM_ITERS * LOCATIONS} partition_kmeans launches a run in the "
          f"workers ({km_launches})")
    check(torch.equal(sums, lsums) and torch.equal(counts, lcounts),
          "cluster kmeans partial: bit-identical to Local's")
    check(torch.equal(counts, pcounts) and torch.allclose(sums, psums, rtol=1e-4, atol=1e-3),
          "cluster kmeans partial: counts equal the plain version's, sums within 1e-4")

    pids = list(ex.worker_pids().values())
    worker_mem = ex.call_workers(torch.cuda.max_memory_allocated)
    worker_reserved = ex.call_workers(torch.cuda.memory_reserved)
    torch.cuda.synchronize()
    used_by_workers = free_before_spawn - torch.cuda.mem_get_info(dev)[0]
    smi = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    prefix = arena.prefix
    ex.close()
    local.close()
    emit({"phase": "cluster", "run": "memory", "workers": len(pids),
          "worker_max_allocated_bytes": sorted(worker_mem.values()),
          "worker_reserved_bytes": sorted(worker_reserved.values()),
          "card_bytes_taken_by_workers": used_by_workers,
          "per_worker_bytes": used_by_workers / max(1, len(pids)),
          "nvidia_smi_compute_apps": smi.stdout.strip().splitlines()})
    check(leaked_segments(prefix) == [], "cluster: no segment outlives close()")
    check(_processes_gone(pids), "cluster: every worker process exited")

    # a worker killed after its first unit of a fused pass: its second unit
    # (SplIter(2): two units a worker) replays on a survivor
    pol2 = SplIter(2, fusion="pallas")
    ref2, ref2_rep = histogram(x_hist, bins=HIST_BINS, policy=pol2)
    kill = FaultPlan(kill_after=((3, 2),))
    ex = engine("cluster", fault_plan=kill, shm_budget_bytes=export + CLUSTER_SHM_SLACK)
    (h, rep), wall = timed(lambda: histogram(x_hist, bins=HIST_BINS, policy=pol2, executor=ex))
    pids = list(ex.worker_pids().values())
    retry_log, prefix = list(ex.retry_log), ex._shm.prefix
    ex.close()
    emit({"phase": "cluster", "run": "kill", "fault_plan": {"kill_after": [[3, 2]]},
          "wall_s": wall, "retries": rep.retries, "retry_log": retry_log,
          "remote_dispatches": rep.remote_dispatches, "dispatches": rep.dispatches,
          "local_dispatches": ref2_rep.dispatches})
    check(torch.equal(h, ref2), "cluster kill: the replayed pass equals Local's bit for bit")
    pinned_merge_bytes = rep.driver_merge_bytes  # a first pass: no observed size, no folds
    check(rep.p2p_bytes == 0 and pinned_merge_bytes == 2 * LOCATIONS * hist_partial,
          f"cluster kill: the SplIter(2) pass pinned, driver_merge_bytes "
          f"{2 * LOCATIONS * hist_partial} ({pinned_merge_bytes})")
    check(rep.retries >= 1 and {e["worker"] for e in retry_log} == {3},
          f"cluster kill: worker 3's lost unit replayed ({retry_log})")
    check(leaked_segments(prefix) == [] and leaked_segments() == [],
          "cluster kill: no segment outlives close()")
    check(_processes_gone(pids), "cluster kill: every worker process exited")

    # one ChaosSchedule: a kill, a straggler and a grow/shrink, with stealing
    cs = ChaosSchedule(seed=CLUSTER_CHAOS_SEED, rounds=CLUSTER_CHAOS_ROUNDS,
                       workers=tuple(range(LOCATIONS)))
    ref1, _ = histogram(x_hist, bins=HIST_BINS, policy=pol)
    ex = engine("cluster", fault_plan=cs.fault_plan(), steal=True, max_workers=LOCATIONS + 4,
                shm_budget_bytes=export + CLUSTER_SHM_SLACK)
    applied, reports, walls, identical = 0, [], [], []
    for action in cs.actions():
        if action == "grow":
            applied += ex.grow() is not None
        elif action == "shrink":
            applied += ex.shrink() is not None
        (h, rep), wall = timed(lambda: histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex))
        reports.append(rep)
        walls.append(wall)
        identical.append(torch.equal(h, ref1))
    logs = (list(ex.steal_log), list(ex.retry_log), list(ex.scale_log))
    pinned, pids, prefix = ex._shm.pinned_segments(), list(ex.worker_pids().values()), ex._shm.prefix
    ex.close()
    emit({"phase": "cluster", "run": "chaos", "seed": CLUSTER_CHAOS_SEED,
          "fault_plan": {"kill_after": cs.fault_plan().kill_after, "slow": cs.fault_plan().slow},
          "actions": cs.actions(), "identical": identical, "wall_s": walls,
          "steals": [r.steals for r in reports], "retries": [r.retries for r in reports],
          "scale_events": [r.scale_events for r in reports], "steal_log": len(logs[0]),
          "retry_log": logs[1], "scale_log": logs[2]})
    check(all(identical), "cluster chaos: every round equals Local's bit for bit")
    check(sum(r.steals for r in reports) == len(logs[0])
          and sum(r.retries for r in reports) == len(logs[1]) and len(logs[2]) == applied,
          "cluster chaos: steals, retries and scale events reconcile exactly with the logs")
    check(pinned == {}, f"cluster chaos: every dispatch pin released ({pinned})")
    check(leaked_segments(prefix) == [] and _processes_gone(pids),
          "cluster chaos: no segment and no worker outlives close()")
    p2p_launches = cluster_p2p_rows(x_hist, x_km, seed, repeats, export, timed, plain_hist,
                                    pinned_merge_bytes)
    for k, n in p2p_launches.items():
        launched[k] += n
    emit({"phase": "cluster", "cluster_launches": launched,
          "driver_launches": sum(driver_launches)})
    check(sum(driver_launches) == 0,
          f"cluster: no kernel launched in the driver during the cluster's runs "
          f"({driver_launches})")
    return launched


def cluster_p2p_rows(x_hist, x_km, seed: int, repeats: int, export: int, timed, plain_hist,
                     pinned_merge_bytes: int) -> dict:
    """The peer exchange forced on (``p2p=True``) under SplIter(2, pallas):
    the two partials of each location are published to shared memory and
    one fold unit a location folds them in its worker, on the card; the
    driver folds the 8 values.  The histogram (1 + ``repeats`` passes) and
    a 10-iteration k-means on one fresh pool, then a fresh pool whose worker
    3 dies on receiving its fold.  Returns the launches in the workers."""
    from repro_torch.api import Collection, FaultPlan, SplIter, engine
    from repro_torch.api.shm import leaked_segments
    from repro_torch.core.apps.histogram import histogram
    from repro_torch.core.apps.kmeans import _combine, kmeans, partial_sum_block
    from repro_torch.kernels import partition_reduce as pr

    pol = SplIter(2, fusion="pallas")
    tasks, on_card = 2 * LOCATIONS, x_hist.device.type == "cuda"
    s_hist = HIST_BINS**HIST_D * 4  # 131,072 B: int32 counts
    s_km = KM_K * KM_D * 4 + KM_K * 4  # 672 B: f32 sums and counts
    launched = {"partition_histogramdd": 0, "partition_kmeans": 0}
    local = engine("local")
    ex = engine("cluster", p2p=True, shm_budget_bytes=export + CLUSTER_SHM_SLACK)
    arena = ex._shm

    def counted(fn):
        c0, e0 = _worker_launches(ex), arena.bytes_exported
        out, wall = timed(fn)
        c1 = _worker_launches(ex)
        return out, wall, {k: c1[k] - c0.get(k, 0) for k in c1}, arena.bytes_exported - e0

    runs, split = [], []
    for _ in range(1 + repeats):
        runs.append(counted(lambda: histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex)))
        split.append(_worker_stats(ex))
    refs = [timed(lambda: histogram(x_hist, bins=HIST_BINS, policy=pol, executor=local),
                  cluster=False) for _ in range(1 + repeats)]
    ref, ref_rep = refs[-1][0]
    reps = [r[0][1] for r in runs]
    hist_launches = [r[2]["partition_histogramdd"] for r in runs]
    launched["partition_histogramdd"] += sum(hist_launches)
    row = {"policy": "spliter2_pallas_p2p", "tasks": tasks,
           "fold_units": [s["folds"] for s in split],
           "dispatches": [r.dispatches for r in reps], "local_dispatches": ref_rep.dispatches,
           "merges": [r.merges for r in reps],
           "remote_dispatches": [r.remote_dispatches for r in reps],
           "ipc_bytes": [r.ipc_bytes for r in reps], "shm_bytes": [r.shm_bytes for r in reps],
           "exported_bytes": [r[3] for r in runs], "retries": [r.retries for r in reps],
           "p2p_bytes": [r.p2p_bytes for r in reps],
           "driver_merge_bytes": [r.driver_merge_bytes for r in reps],
           "pinned_driver_merge_bytes": pinned_merge_bytes,
           "launches_per_pass": hist_launches, "first_pass_wall_s": runs[0][1],
           "wall_s": statistics.median(r[1] for r in runs[1:]),
           "local_wall_s": statistics.median(r[1] for r in refs[1:]),
           "fold_s": [s["fold_s"] for s in split], "split_s": split}
    emit({"phase": "cluster", "run": "histogram/spliter2_pallas_p2p", **row})
    what = "cluster histogram/spliter2_pallas_p2p"
    check(all(torch.equal(r[0][0], ref) and torch.equal(r[0][0], plain_hist) for r in runs),
          f"{what}: counts equal Local's and the plain partition_histogramdd's")
    check(all(r.p2p_bytes == tasks * s_hist and r.driver_merge_bytes == LOCATIONS * s_hist
              for r in reps) and ref_rep.driver_merge_bytes == tasks * s_hist
          and pinned_merge_bytes == tasks * s_hist,
          f"{what}: p2p_bytes {tasks * s_hist} and driver_merge_bytes {LOCATIONS * s_hist} a "
          f"pass, where Local's and the pinned pass's are {tasks * s_hist}")
    check(all(r.dispatches == ref_rep.dispatches + LOCATIONS
              and r.merges == ref_rep.merges + LOCATIONS
              and r.remote_dispatches == tasks + LOCATIONS and r.retries == 0 for r in reps),
          f"{what}: Local's dispatches and merges plus {LOCATIONS} fold units, "
          f"{tasks + LOCATIONS} remote dispatches, no retries")
    check([r[3] for r in runs] == [x_hist.nbytes] + [0] * repeats
          and all(r.shm_bytes == e[3] + (tasks + LOCATIONS) * s_hist for r, e in zip(reps, runs)),
          f"{what}: shm_bytes = the export + {tasks} published partials + {LOCATIONS} fold replies")
    check([s["folds"] for s in split] == [LOCATIONS] * (1 + repeats),
          f"{what}: {LOCATIONS} fold units a pass ran in the workers")
    check(hist_launches == [tasks * on_card] * (1 + repeats),
          f"{what}: {tasks} partition_histogramdd launches a pass in the workers ({hist_launches})")

    c0 = _worker_launches(ex)
    km, km_wall = timed(lambda: kmeans(x_km, k=KM_K, iters=KM_ITERS, seed=seed, policy=pol,
                                       executor=ex))
    km_split = _worker_stats(ex)
    km_launches = _worker_launches(ex)["partition_kmeans"] - c0["partition_kmeans"]
    km_ref, km_local_wall = timed(lambda: kmeans(x_km, k=KM_K, iters=KM_ITERS, seed=seed,
                                                 policy=pol, executor=local), cluster=False)
    plan = (Collection.from_blocked(x_km).split(pol)
            .map_blocks(partial_sum_block, extra_args=(km_ref.centers,)).reduce(_combine))
    c1 = _worker_launches(ex)["partition_kmeans"]
    (sums, counts), _ = timed(lambda: plan.compute(executor=ex).value)
    km_check_launches = _worker_launches(ex)["partition_kmeans"] - c1
    lsums, lcounts = plan.compute(executor=local).value
    psums, pcounts = torch.zeros_like(lsums), torch.zeros_like(lcounts)
    for loc in range(LOCATIONS):
        st_ = torch.stack([x_km.block(b) for b in x_km.blocks_at(loc)])
        s_, c_ = pr.partition_kmeans_ref(st_, km_ref.centers)
        psums += s_
        pcounts += c_
    del st_
    launched["partition_kmeans"] += km_launches + km_check_launches
    km_row = {"policy": "kmeans/spliter2_pallas_p2p", "iterations": KM_ITERS,
              "fold_units": km_split["folds"], "fold_s": km_split["fold_s"],
              "dispatches": [r.dispatches for r in km.reports],
              "local_dispatches": [r.dispatches for r in km_ref.reports],
              "remote_dispatches": [r.remote_dispatches for r in km.reports],
              "shm_bytes": [r.shm_bytes for r in km.reports],
              "p2p_bytes": [r.p2p_bytes for r in km.reports],
              "driver_merge_bytes": [r.driver_merge_bytes for r in km.reports],
              "local_driver_merge_bytes": [r.driver_merge_bytes for r in km_ref.reports],
              "retries": [r.retries for r in km.reports], "launches_per_run": km_launches,
              "wall_s": km_wall, "local_wall_s": km_local_wall,
              "iteration_wall_s": [r.wall_s for r in km.reports],
              "local_iteration_wall_s": [r.wall_s for r in km_ref.reports], "split_s": km_split,
              "partial_max_abs_err_vs_plain": float((sums - psums).abs().max())}
    emit({"phase": "cluster", "run": "kmeans/spliter2_pallas_p2p", **km_row})
    what = "cluster kmeans/spliter2_pallas_p2p"
    check(torch.equal(km.centers, km_ref.centers),
          f"{what}: centers bit-identical to Local's SplIter(2) (the same fold association)")
    check(all(r.p2p_bytes == tasks * s_km and r.driver_merge_bytes == LOCATIONS * s_km
              for r in km.reports)
          and all(r.driver_merge_bytes == tasks * s_km for r in km_ref.reports),
          f"{what}: p2p_bytes {tasks * s_km} and driver_merge_bytes {LOCATIONS * s_km} an "
          f"iteration (Local's {tasks * s_km})")
    check([r.dispatches for r in km.reports]
          == [r.dispatches + LOCATIONS for r in km_ref.reports]
          and all(r.retries == 0 for r in km.reports),
          f"{what}: Local's dispatches plus {LOCATIONS} fold units an iteration, no retries")
    check(km_split["folds"] == KM_ITERS * LOCATIONS,
          f"{what}: {KM_ITERS * LOCATIONS} fold units ran in the workers ({km_split['folds']})")
    check(km_launches == KM_ITERS * tasks * on_card,
          f"{what}: {KM_ITERS * tasks} partition_kmeans launches a run in the workers "
          f"({km_launches})")
    check(torch.equal(sums, lsums) and torch.equal(counts, lcounts)
          and torch.equal(counts, pcounts) and torch.allclose(sums, psums, rtol=1e-4, atol=1e-3),
          f"{what}: the folded partial equals Local's bit for bit and the plain "
          f"partition_kmeans's (counts exactly, sums within 1e-4)")
    pids, prefix = list(ex.worker_pids().values()), arena.prefix
    ex.close()
    local.close()
    check(leaked_segments(prefix) == [] and _processes_gone(pids),
          "cluster p2p: no segment (published partials included) and no worker outlives close()")

    # worker 3 dies on receiving its fold (its third dispatch, after its two
    # units published): the fold replays on a survivor over the same segments
    kill = FaultPlan(kill_after=((3, 3),))
    ex = engine("cluster", p2p=True, fault_plan=kill, shm_budget_bytes=export + CLUSTER_SHM_SLACK)
    (h, rep), wall = timed(lambda: histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex))
    folds = _worker_stats(ex)["folds"]  # the survivors' (the dead worker's are gone)
    pids, prefix, retry_log = list(ex.worker_pids().values()), ex._shm.prefix, list(ex.retry_log)
    ex.close()
    emit({"phase": "cluster", "run": "fold_kill", "fault_plan": {"kill_after": [[3, 3]]},
          "wall_s": wall, "retries": rep.retries, "retry_log": retry_log,
          "fold_units_in_survivors": folds, "p2p_bytes": rep.p2p_bytes,
          "driver_merge_bytes": rep.driver_merge_bytes, "dispatches": rep.dispatches})
    check(torch.equal(h, ref), "cluster fold kill: the replayed pass equals Local's bit for bit")
    check(rep.retries >= 1 and [(e["worker"], e["unit"] >= tasks) for e in retry_log]
          == [(3, True)],
          f"cluster fold kill: worker 3's fold replayed ({retry_log})")
    check(rep.p2p_bytes == tasks * s_hist and rep.driver_merge_bytes == LOCATIONS * s_hist
          and folds == LOCATIONS,
          f"cluster fold kill: the bill stays exact ({rep.p2p_bytes}, {rep.driver_merge_bytes}) "
          f"and all {LOCATIONS} folds ran in the surviving workers ({folds})")
    check(leaked_segments(prefix) == [] and leaked_segments() == [] and _processes_gone(pids),
          "cluster fold kill: no segment and no worker outlives close()")
    return launched


#: the service phase's durable submissions (each journals the histogram's
#: 671,088,640 B of blocks): one killed and resumed job, and one per backend
#: and fsync setting for the timing
SERVICE_WATCHDOG_S = 300.0


def _watch(server, predicate, *, stop: bool = False):
    """An event set the first time ``predicate(job, kind)`` holds for a
    lifecycle event the server emits.  With ``stop`` the scheduler stops
    right there, on its own thread, so the next ``kill()`` finds exactly
    that state."""
    import threading

    hit = threading.Event()
    emit_ = server._emit

    def watched(job, kind, detail="", completed=0, total=0):
        emit_(job, kind, detail, completed, total)
        if not hit.is_set() and predicate(job, kind):
            if stop:
                server._stop.set()
            hit.set()

    server._emit = watched
    return hit


def service_phase(x_hist, x_km, seed: int, repeats: int) -> dict:
    """The job service on the card: two weighted tenants multiplexed onto
    one pool, stride fairness, a durable job killed and resumed, and the
    journal's cost.  Returns the kernel launches of the server runs."""
    import functools
    import operator
    import tempfile
    import threading

    from repro_torch.api import Collection, JobClient, JobServer, SplIter, engine
    from repro_torch.core.apps.histogram import histogram, histogramdd_block
    from repro_torch.core.apps.kmeans import kmeans
    from repro_torch.kernels import partition_reduce as pr

    pol = SplIter(1, fusion="pallas")
    mesh = (x_hist.device,)  # the mesh backend's one rank: the card the data is on
    reset_launches()  # the phase's launches: counted from 0, read at its end
    launched = {"partition_histogramdd": 0, "partition_kmeans": 0}
    hist_fn = functools.partial(histogramdd_block, bins=HIST_BINS, lo=0.0, hi=1.0)
    # operator.add, not torch.add: a builtin of torch has no importable
    # reference, and a durable job's combine must have one
    plan = (Collection.from_blocked(x_hist).split(pol).map_blocks(hist_fn)
            .reduce(operator.add).plan())

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, time.perf_counter() - t0

    def counted(fn):
        h0, k0 = pr.partition_histogramdd.launches, pr.partition_kmeans.launches
        out = fn()
        launched["partition_histogramdd"] += pr.partition_histogramdd.launches - h0
        launched["partition_kmeans"] += pr.partition_kmeans.launches - k0
        return out

    # direct calls on a LocalExecutor: the values every server run must give
    h0, k0 = pr.partition_histogramdd.launches, pr.partition_kmeans.launches
    with engine("local") as ex:
        runs = [synced(lambda: histogram(x_hist, bins=HIST_BINS, policy=pol, executor=ex)[0])
                for _ in range(1 + repeats)]
        ref_h, direct_hist_s = runs[0][0], statistics.median(w for _, w in runs[1:])
        runs = [synced(lambda: kmeans(x_km, k=KM_K, iters=KM_ITERS, seed=seed, policy=pol,
                                      executor=ex)) for _ in range(1 + repeats)]
        ref_k, direct_km_s = runs[0][0], statistics.median(w for _, w in runs[1:])
    direct = {"partition_histogramdd": pr.partition_histogramdd.launches - h0,
              "partition_kmeans": pr.partition_kmeans.launches - k0}

    for backend in ("local", "mesh"):
        # -- two tenants, weights 2:1: histogram passes and a k-means run ---
        srv = engine("server", server_backend=backend, devices=mesh, autostart=False)
        hist_client = JobClient(srv, tenant="histogram", weight=2)
        km_client = JobClient(srv, tenant="kmeans", weight=1)
        got = {}

        def run_hist():
            got["h"] = [histogram(x_hist, bins=HIST_BINS, policy=pol, executor=hist_client)[0]
                        for _ in range(repeats)]

        def run_km():
            got["k"] = kmeans(x_km, k=KM_K, iters=KM_ITERS, seed=seed, policy=pol,
                              executor=km_client)

        tenants = set()
        queued = _watch(srv, lambda job, kind: kind == "queued" and (
            tenants.add(job.tenant) or len(tenants) == 2))
        threads = [threading.Thread(target=run_hist), threading.Thread(target=run_km)]

        def both():
            for t in threads:
                t.start()
            check(queued.wait(SERVICE_WATCHDOG_S), "service: both tenants admitted")
            srv.start()
            for t in threads:
                t.join(SERVICE_WATCHDOG_S)
            check(not any(t.is_alive() for t in threads), "service: both tenants finished")

        _, wall = synced(lambda: counted(both))
        srv.close()
        check(all(torch.equal(h, ref_h) for h in got["h"]),
              f"service/{backend}: every histogram equals the direct Local call's")
        check(torch.equal(got["k"].centers, ref_k.centers),
              f"service/{backend}: k-means centers equal the direct Local run's bit for bit")
        owners = [srv._jobs[e.job_id].tenant for e in srv.event_log
                  if e.kind in ("running", "merged") and e.total]
        # the window in which both tenants had work: up to the first one's last unit
        last = {t: len(owners) - 1 - owners[::-1].index(t) for t in set(owners)}
        window = owners[:min(last.values()) + 1]
        slots = {t: window.count(t) for t in ("histogram", "kmeans")}
        two = {"phase": "service", "backend": backend, "run": "two_tenants",
               "weights": {"histogram": 2, "kmeans": 1}, "histogram_passes": repeats,
               "kmeans_iterations": KM_ITERS, "jobs": len(srv.jobs()), "wall_s": wall,
               "direct_wall_s": repeats * direct_hist_s + direct_km_s,
               "unit_slots_while_both_open": slots,
               "slot_ratio": slots["histogram"] / max(slots["kmeans"], 1),
               "job_walls_s": {t: [j.report.wall_s for j in srv.jobs() if j.tenant == t]
                               for t in ("histogram", "kmeans")}}
        emit(two)

        # -- stride fairness: three jobs each, submitted before the start ---
        srv = engine("server", server_backend=backend, devices=mesh, autostart=False)
        heavy = [srv.submit(plan, tenant="heavy", weight=2) for _ in range(3)]
        light = [srv.submit(plan, tenant="light", weight=1) for _ in range(3)]
        counted(lambda: (srv.start(), [srv.wait(j, SERVICE_WATCHDOG_S) for j in heavy + light]))
        srv.close()
        check(all(torch.equal(j.result, ref_h) for j in heavy + light),
              f"service/{backend}: fairness jobs equal the direct call's")
        owners = [srv._jobs[e.job_id].tenant for e in srv.event_log
                  if e.kind in ("running", "merged") and e.total]
        window = owners[:len(owners) - 1 - owners[::-1].index("heavy") + 1]
        h, l_ = window.count("heavy"), window.count("light")
        fair = {"phase": "service", "backend": backend, "run": "fairness",
                "units_per_job": heavy[0].total_units, "heavy_units": h,
                "light_units_meanwhile": l_}
        emit(fair)
        check(abs(h - 2 * l_) <= 2,
              f"service/{backend}: weight 2 ran twice weight 1's units while both were open "
              f"({h} / {l_})")

        # -- the journal's cost: one durable job with fsync on and off -------
        timing = []
        for fsync in (True, False):
            with tempfile.TemporaryDirectory() as root:
                (_, encode_s) = synced(lambda: JobServer._encode_payload(plan.spec))
                srv = engine("server", server_backend=backend, devices=mesh, root=root,
                             fsync=fsync)

                def submit_and_wait():
                    # the scheduler may run units before submit returns:
                    # the count spans both
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    job = srv.submit(plan, tenant="t")
                    submit_s = time.perf_counter() - t0
                    value, run_s = synced(lambda: srv.wait(job, SERVICE_WATCHDOG_S).value)
                    return job, submit_s, value, run_s

                job, submit_s, value, run_s = counted(submit_and_wait)
                journal_bytes = os.path.getsize(os.path.join(root, "journal.bin"))
                srv.close()
            check(torch.equal(value, ref_h), f"service/{backend} fsync={fsync}: value exact")
            timing.append({"fsync": fsync, "encode_payload_s": encode_s, "submit_s": submit_s,
                           "job_wall_after_submit_s": run_s, "direct_wall_s": direct_hist_s,
                           "journal_bytes": journal_bytes, "units": job.total_units})
        emit({"phase": "service", "backend": backend, "run": "durable_job", "timing": timing})

    # -- a durable histogram job killed after two units, resumed by a fresh server
    with tempfile.TemporaryDirectory() as root:
        srv = engine("server", server_backend="local", root=root, snapshot_every=2,
                     autostart=False)
        job = srv.submit(plan, tenant="alice")
        reached = _watch(srv, lambda j, kind: kind == "running" and j.recomputed_units >= 2,
                         stop=True)
        counted(lambda: (srv.start(), reached.wait(SERVICE_WATCHDOG_S)))
        check(reached.is_set(), "service: the durable job ran two units")
        srv.kill()
        done_at_kill = job.recomputed_units
        check(job.status == "running" and done_at_kill < job.total_units,
              f"service: killed mid-job ({job.status}, {done_at_kill}/{job.total_units})")
        h0 = pr.partition_histogramdd.launches
        srv2, restart_s = synced(lambda: engine("server", server_backend="local", root=root))
        job2 = srv2.jobs()[0]
        value, resume_s = synced(lambda: srv2.wait(job2, SERVICE_WATCHDOG_S).value)
        resumed_launches = pr.partition_histogramdd.launches - h0
        launched["partition_histogramdd"] += resumed_launches
        srv2.close()
    resumed = {"phase": "service", "run": "kill_and_resume", "total_units": job2.total_units,
               "done_at_kill": done_at_kill, "restored_units": job2.restored_units,
               "recomputed_units": job2.recomputed_units, "resumed_launches": resumed_launches,
               "inputs_device": str(job2.spec.inputs[0].device), "value_device": str(value.device),
               "restart_s": restart_s, "resume_s": resume_s}
    emit(resumed)
    check(srv2.resumed_jobs == 1 and job2.restored_units == done_at_kill,
          "service: the restart restored the journaled units")
    check(job2.restored_units + job2.recomputed_units == job2.total_units,
          "service: restored + recomputed units = total units")
    check(torch.equal(value, ref_h), "service: the resumed job's value equals the direct call's")
    check(job2.spec.inputs[0].device.type == "cuda" and value.is_cuda,
          "service: the resumed job's inputs were rebuilt on the card")
    # every recomputed unit but the merge is a task: one kernel launch each
    check(resumed_launches == job2.recomputed_units - 1 > 0,
          f"service: the resumed units launched partition_histogramdd on the card "
          f"({resumed_launches} for {job2.recomputed_units - 1} task units)")
    emit({"phase": "service", "service_launches": launched})
    counts = read_launches()
    want = {**{k: launched[k] + direct[k] for k in launched},
            "partition_histogram": 0, "flash_attention": 0, "ssd_scan": 0}
    check(counts == want,
          f"service: the counters, set to 0 at the phase's start, equal the server runs' "
          f"and the direct calls' launches ({counts}; server runs {launched}, direct {direct})")
    check(all(n > 0 for n in launched.values()),
          f"both partition kernels launched through the service: {launched}")
    return launched


KNN_D, KNN_K = 3, 8  # benchmarks/bench_knn.py:98
KNN_FIT_BLOCK_ROWS, KNN_Q_BLOCKS, KNN_Q_BLOCK_ROWS = 8_192, 2, 512
KNN_TOL = 1e-4


def same_up_to_ties(a, b) -> int:
    """Check two kNN results name the same neighbors, up to equal distances.

    Equal f32 distances (the expanded |q|² − 2q·f + |f|² rounds them to
    about 1.2e-7 near |q|² = 1, so neighbors' distances collide) are ordered
    by candidate position, which follows each policy's structures, as in
    the reference.  Each row's sorted distances must agree within 1e-6; an
    id in one result and not the other must lie within 1e-6 of the row's
    k-th distance.  Returns the number of rows whose ids differ.
    """
    check(float((a.distances - b.distances).abs().max()) <= 1e-6,
          "knn: sorted distances agree across policies within 1e-6")
    ia, ib = a.indices.sort(1).values, b.indices.sort(1).values
    rows = (ia != ib).any(1).nonzero().flatten().tolist()
    for r in rows:
        for x, y in ((a, b), (b, a)):
            extra = ~torch.isin(x.indices[r], y.indices[r])
            kth = float(x.distances[r, -1])
            check(bool((x.distances[r][extra] >= kth - 1e-6).all()),
                  f"knn: row {r} differs across policies only at the k-th distance")
    return len(rows)


def knn_phase(seed: int, dev: torch.device) -> dict:
    """kNN at the bench's width under four policies on both executors."""
    import numpy as np

    from repro_torch.api import Baseline, Rechunk, SplIter, engine
    from repro_torch.core.apps import knn
    from repro_torch.core.blocked import BlockedArray, round_robin_placement

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "knn: the distance product runs in f32, not TF32")
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    n_fit = LOCATIONS * BLOCKS_PER_LOCATION * KNN_FIT_BLOCK_ROWS
    n_q = LOCATIONS * KNN_Q_BLOCKS * KNN_Q_BLOCK_ROWS
    fit_t = torch.rand((n_fit, KNN_D), generator=gen, device=dev)
    q_t = torch.rand((n_q, KNN_D), generator=gen, device=dev)
    fit = BlockedArray.from_array(fit_t, KNN_FIT_BLOCK_ROWS, num_locations=LOCATIONS,
                                  policy=round_robin_placement, device=dev)
    queries = BlockedArray.from_array(q_t, KNN_Q_BLOCK_ROWS, num_locations=LOCATIONS,
                                      policy=round_robin_placement, device=dev)
    policies = {"baseline": Baseline(), "spliter1": SplIter(1), "spliter2": SplIter(2),
                "rechunk": Rechunk()}
    results, rows = {}, []
    for pname, pol in policies.items():
        for backend in ("local", "threaded"):
            with engine(backend) as ex:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = knn(fit, queries, k=KNN_K, policy=pol, executor=ex)
                wall = time.perf_counter() - t0
            results[(pname, backend)] = r
            rows.append({"policy": pname, "executor": backend, "wall_s": wall,
                         "dispatches": r.report.dispatches, "merges": r.report.merges,
                         "bytes_moved": r.report.bytes_moved})
    for pname in policies:
        loc, thr = results[(pname, "local")], results[(pname, "threaded")]
        check(torch.equal(loc.indices, thr.indices) and torch.equal(loc.distances, thr.distances),
              f"knn {pname}: Local and Threaded give the same ids and distances bit for bit")
    ref = results[("baseline", "local")]
    tie_rows = {p: same_up_to_ties(ref, results[(p, "local")]) for p in policies}
    for backend in ("local", "threaded"):
        b, s1 = results[("baseline", backend)].report, results[("spliter1", backend)].report
        check(s1.dispatches < b.dispatches and s1.merges < b.merges,
              f"knn {backend}: SplIter dispatches and merges below Baseline's")
    # brute force on the card: differences squared, in chunks of queries
    chunk, want, gap = 32, [], []
    for i in range(0, n_q, chunk):
        d2 = ((q_t[i:i + chunk, None, :] - fit_t[None]) ** 2).sum(-1)
        vals = torch.topk(d2, KNN_K + 1, dim=1, largest=False).values
        want.append(vals[:, :KNN_K])
        gap.append(vals[:, KNN_K] - vals[:, KNN_K - 1])
    want, gap = torch.cat(want), torch.cat(gap)
    clear = gap > KNN_TOL
    dist_err = float((ref.distances - want).abs().max())
    check(dist_err <= KNN_TOL, f"knn distances within {KNN_TOL} of brute force ({dist_err})")
    own = ((q_t[:, None, :] - fit_t[ref.indices.long()]) ** 2).sum(-1)
    id_err = float((own - ref.distances).abs().max())
    check(id_err <= KNN_TOL, f"knn: each id's own distance is the reported one ({id_err})")
    # duplicated fit rows tie exactly: the card keeps the CPU's copies and
    # order.  Coordinates on a 1/16 grid make every distance exact on both.
    rng = np.random.default_rng(seed)
    base = (rng.integers(0, 16, (4_000, KNN_D)) / 16).astype(np.float32)
    dup_fit = np.concatenate([base] * 3)
    dup_q = (rng.integers(0, 16, (256, KNN_D)) / 16).astype(np.float32)
    tie_ok = {}
    for pname in ("baseline", "spliter1"):
        ids = []
        for device in ("cpu", dev):
            f = BlockedArray.from_array(dup_fit, 750, num_locations=LOCATIONS,
                                        policy=round_robin_placement, device=device)
            qq = BlockedArray.from_array(dup_q, 128, num_locations=LOCATIONS,
                                         policy=round_robin_placement, device=device)
            ids.append(knn(f, qq, k=KNN_K, policy=policies[pname]).indices.cpu())
        tie_ok[pname] = bool(torch.equal(ids[0], ids[1]))
        check(tie_ok[pname], f"knn {pname}: duplicated rows give the CPU's ids on the card")
    result = {"phase": "knn", "fit_rows": n_fit, "queries": n_q, "d": KNN_D, "k": KNN_K,
              "runs": rows, "distance_max_abs_err_vs_brute_force": dist_err,
              "rows_with_kth_gap_over_tol": int(clear.sum()), "id_distance_max_abs_err": id_err,
              "rows_differing_from_baseline_by_ties": tie_rows,
              "duplicated_rows_ids_equal_cpu": tie_ok}
    emit(result)
    return result


SVM_BLOCKS_PER_LOCATION, SVM_BLOCK_ROWS, SVM_D = 8, 512, 8  # benchmarks/bench_svm.py:37,119
#: the quick mode's 100 steps (``benchmarks/bench_svm.py:120``), not the full
#: mode's 300: cut for the script's time limit
SVM_NUM_SV, SVM_STEPS, SVM_ITERATIONS = 32, 100, 2


def svm_phase(seed: int, dev: torch.device) -> dict:
    """Cascade SVM at the bench's full mode on both executors."""
    import numpy as np

    from repro_torch.api import Baseline, Rechunk, SplIter, engine
    from repro_torch.core.apps import cascade_svm
    from repro_torch.core.blocked import BlockedArray, round_robin_placement

    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    n = LOCATIONS * SVM_BLOCKS_PER_LOCATION * SVM_BLOCK_ROWS
    pts = torch.randn((n, SVM_D), generator=gen, device=dev)
    w = torch.randn((SVM_D,), generator=gen, device=dev)
    labels = torch.sign(pts @ w + 0.05 * torch.randn((n,), generator=gen, device=dev))
    x, y = (BlockedArray.from_array(a, SVM_BLOCK_ROWS, num_locations=LOCATIONS,
                                    policy=round_robin_placement, device=dev)
            for a in (pts, labels))
    policies = {"baseline": Baseline(), "spliter1": SplIter(1), "spliter2": SplIter(2),
                "rechunk": Rechunk()}
    rows, dispatches = [], {}
    for pname, pol in policies.items():
        got = {}
        for backend in ("local", "threaded"):
            with engine(backend) as ex:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = cascade_svm(x, y, num_sv=SVM_NUM_SV, steps=SVM_STEPS,
                                iterations=SVM_ITERATIONS, policy=pol, executor=ex)
                wall = time.perf_counter() - t0
            got[backend] = r
            rows.append({"policy": pname, "executor": backend, "wall_s": wall,
                         "dispatches": r.report.dispatches, "merges": r.report.merges,
                         "bytes_moved": r.report.bytes_moved})
        loc, thr = got["local"], got["threaded"]
        check(torch.equal(loc.sv_x, thr.sv_x) and torch.equal(loc.sv_y, thr.sv_y)
              and torch.equal(loc.sv_alpha, thr.sv_alpha),
              f"svm {pname}: support vectors bit-identical between Local and Threaded")
        match = (loc.sv_x[:, None, :] == pts[None]).all(-1)  # (num_sv, n)
        paired = match.any(1) & (labels[match.int().argmax(1)] == loc.sv_y)
        check(bool(paired.all()), f"svm {pname}: every SV is an actual (x, y) pair")
        dispatches[pname] = loc.report.dispatches
    check(dispatches["spliter1"] < dispatches["baseline"],
          f"svm: SplIter dispatches below Baseline's ({dispatches})")
    # training accuracy as tests/test_core_apps.py:109-116 holds it: its data
    # (256 rows of 4, blocks of 32 on 4 locations), 128 SVs, c = 10
    rng = np.random.default_rng(3)
    xs = rng.normal(size=(256, 4)).astype(np.float32)
    ys = np.sign(xs @ rng.normal(size=(4,)).astype(np.float32) + 0.1).astype(np.float32)
    xb, yb = (BlockedArray.from_array(a, 32, num_locations=4, policy=round_robin_placement,
                                      device=dev) for a in (xs, ys))
    small = cascade_svm(xb, yb, num_sv=128, steps=SVM_STEPS, iterations=SVM_ITERATIONS,
                        policy=SplIter(), c=10.0)
    xs_t, ys_t = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    acc = float((torch.sign(small.decision(xs_t)) == ys_t).float().mean())
    check(acc > 0.85, f"svm training accuracy {acc} > 0.85 (the reference test's data)")
    # at this phase's size 128 SVs underfit 32,768 rows (the reference too)
    full = cascade_svm(x, y, num_sv=128, steps=SVM_STEPS, iterations=SVM_ITERATIONS,
                       policy=SplIter(), c=10.0)
    acc_full = float((torch.sign(full.decision(pts)) == labels).float().mean())
    result = {"phase": "svm", "rows": n, "d": SVM_D, "num_sv": SVM_NUM_SV, "steps": SVM_STEPS,
              "iterations": SVM_ITERATIONS, "runs": rows,
              "train_accuracy_test_data_num_sv128_c10": acc,
              "train_accuracy_full_num_sv128_c10": acc_full}
    emit(result)
    return result


# ---------------------------------------------------------------------------
# train: the SplIter trainer on the card
# ---------------------------------------------------------------------------

#: lm100m's step: global batch 32 in 4 blocks of 8 × 1024 tokens, 12 steps
TRAIN_BATCH, TRAIN_BLOCKS, TRAIN_SEQ, TRAIN_STEPS = 32, 4, 1024, 12
TRAIN_MODES = ("spliter", "per_block", "materialized")
#: the three modes' f32 gradients of step 1 (bf16 compute): a leaf's largest
#: difference from ``spliter``'s over the leaf's largest magnitude.
#: ``per_block`` sums the same block gradients in the same order;
#: ``materialized`` runs each product over 4× the rows, whose bf16 sums
#: round apart
TRAIN_GRAD_TOL = {"per_block": 1e-6, "materialized": 5e-2}
#: the first-step losses of the three modes, relative
TRAIN_LOSS_RTOL = 1e-3
#: every smoke config's f32 step on the card against the CPU: the loss,
#: relative, and a gradient leaf's largest difference over its largest
#: magnitude (f32 sums in another order; no TF32)
SMOKE_LOSS_RTOL, SMOKE_GRAD_TOL = 1e-5, 1e-3
#: mamba2-1.3b at 2 layers of full width, f32, peak lr 1e-3: steps on the
#: card and on the CPU from the same params, each step's loss relative
#: (AdamW's early updates are about lr·sign(g), so a gradient that rounds to
#: the other sign moves its weight by up to 2·lr: held by losses).  One
#: sequence of 512 a step, one warm-up step, so that the second step runs
#: at the peak and the third step's loss reads its result (cut for the
#: script's time limit: the CPU's steps are most of the phase)
WITNESS_STEPS, WITNESS_LOSS_RTOL = 3, 1e-3
#: mamba2-1.3b's bf16 steps at full width, 16 of its 48 layers (cut for the
#: script's time limit)
TRAIN_MAMBA2_LAYERS = 16


def _train_counters() -> dict:
    """Every kernel's launch count, and the flash kernel's split route's."""
    split, kv = split_launches()
    return {**read_launches(), "flash_attention_split": split, "split_kv": kv}


def train_step_bound_ms(cfg, params, tokens: int, seq: int, remat: bool) -> float:
    """Least time of one step's matrix products in bf16 on an H100 SXM: two
    operations per weight of a product and token forward, twice that
    backward (three times forward in all; four with full recomputation),
    the causal attention's two products over half the square per layer, and
    the head over the padded vocabulary (the embedding is a gather)."""
    trunk = sum(_numel(seg) for key, seg in params.items() if key.startswith("seg"))
    head = cfg.d_model * cfg.padded_vocab
    flops = 2 * (trunk + head) * tokens
    attn_layers = sum(seg.repeats * sum(spec.mixer == "attn" for spec in seg.period)
                      for seg in cfg.segments())
    flops += attn_layers * 2 * 2 * (seq * seq // 2) * cfg.num_heads * cfg.resolved_head_dim \
        * (tokens // seq)
    return 1e3 * flops * (4 if remat else 3) / BF16_FLOPS_PER_S


def _grad_gap(a, b) -> float:
    """A leaf's largest difference over the leaf's largest magnitude (b's),
    the largest over the tree."""
    from repro_torch._pytree import tree_leaves

    worst = 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        scale = float(y.abs().max()) if y.numel() else 0.0
        gap = float((x.float() - y.float()).abs().max()) if y.numel() else 0.0
        worst = max(worst, gap / scale if scale else gap)
    return worst


def _timed_steps(trainer, params, opt, steps: int, dev) -> tuple:
    """``steps`` train steps from ``params``/``opt`` (consumed): per-step
    host ms (each ends reading the loss), losses, dispatches per step."""
    ms, losses, dispatches = [], [], set()
    for s in range(steps):
        blocks = trainer.pipeline.peek(s)
        t0 = time.perf_counter()
        params, opt, loss, nd = trainer.train_step(params, opt, blocks)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        dispatches.add(nd)
    return params, opt, ms, losses, dispatches


def _launch_site(event) -> str:
    """Where a kernel was launched from: the backward function that ran it
    (or ``forward``) and the outermost aten op around the launching op,
    with its input shapes."""
    chain, e = [], event
    while e is not None:
        chain.append(e)
        e = e.cpu_parent
    i = next((j for j, c in enumerate(chain)
              if c.name.startswith("autograd::engine::evaluate_function")), len(chain))
    grad_fn = chain[i].name.split(": ")[-1] if i < len(chain) else "forward"
    aten = [c for c in chain[:i] if c.name.startswith("aten::")]
    outer = aten[-1] if aten else event
    return f"{grad_fn} | {outer.name}{[list(s) for s in (outer.input_shapes or []) if s]}"


def profile_step(trainer, params, opt, blocks: dict, step_ms: float) -> dict:
    """One train step under ``torch.profiler``: the card's busy time (the
    kernels' summed self time), the span from the first kernel's start to
    the last one's end, the idle share of the unprofiled step
    (``1 - busy / step_ms``, ``step_ms`` the same run's median step: the
    profiled wall holds the profiler's own host work, so it is reported
    apart and not divided by), the kernels' launches, the 8 kernels of most
    device time, and for the first 6 of them their 5 largest launch sites
    (``_launch_site``) by device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        _, _, loss, _ = trainer.train_step(params, opt, blocks)
        float(loss)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    events = prof.events()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    span_ms = ((max(e.time_range.end for e in on_card) - min(e.time_range.start for e in on_card))
               / 1e3 if on_card else None)
    named = {e.key: {} for e in kernels[:6]}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        for k in e.kernels:
            if k.name in named:
                site = named[k.name].setdefault(_launch_site(e), [0.0, 0])
                site[0] += k.duration / 1e3
                site[1] += 1
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernel_span_ms": span_ms, "step_ms": step_ms,
            "device_idle_share": 1 - busy_ms / step_ms,
            "kernel_launches": sum(e.count for e in kernels),
            "top_kernels": [{"name": e.key[:90], "ms": e.self_device_time_total / 1e3,
                             "calls": e.count} for e in kernels[:8]],
            "launch_sites": [
                {"kernel": name[:90], "ms": sum(v[0] for v in found.values()),
                 "sites": [{"site": site, "ms": v[0], "calls": v[1]} for site, v in
                           sorted(found.items(), key=lambda kv: -kv[1][0])[:5]]}
                for name, found in named.items()]}


def train_phase(seed: int, dev: torch.device, card: str) -> dict:
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch._pytree import tree_leaves, tree_map
    from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import _preset
    from repro_torch.models import build_model
    from repro_torch.optim import accumulate_gradients, adamw_init, adamw_update
    from repro_torch.runtime import TrainConfig, Trainer
    from repro_torch.runtime.ft import PreemptionGuard

    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    before = _train_counters()
    t_phase = time.perf_counter()

    # ---- the repair: the kernels refuse a gradient ----
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((2, 128, 4, 64), generator=g, device=dev, dtype=torch.bfloat16)
    refused = {}
    for name, call in (
        ("flash_attention", lambda: ops.flash_attention(q.clone().requires_grad_(), q, q)),
        ("ssd_scan", lambda: ops.ssd_scan(
            torch.randn((1, 128, 2, 16), device=dev).requires_grad_(),
            torch.rand((1, 128, 2), device=dev), -torch.rand((2,), device=dev),
            torch.randn((1, 128, 8), device=dev), torch.randn((1, 128, 8), device=dev),
            chunk=64)),
    ):
        try:
            call()
            refused[name] = False
        except RuntimeError as err:
            refused[name] = "no backward" in str(err)
    emit({"phase": "train", "run": "refusal", "card": card, "raised": refused})
    check(all(refused.values()), f"kernels refuse an operand that requires a gradient: {refused}")

    # ---- lm100m whole in the three modes ----
    mc = dataclasses.replace(_preset("lm100m"), attn_impl="flash")
    kw = dict(global_batch=TRAIN_BATCH, num_blocks=TRAIN_BLOCKS, seq_len=TRAIN_SEQ,
              steps=TRAIN_STEPS, peak_lr=1e-3, warmup_steps=2, seed=seed)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    first_losses, grads = {}, {}
    for mode in TRAIN_MODES:
        tr = Trainer(mc, TrainConfig(accum_mode=mode, **kw), device=dev)
        params, opt = tr.init_state()
        if mode == TRAIN_MODES[0]:
            n_params = sum(t.numel() for t in tree_leaves(params))
            bound_ms = train_step_bound_ms(mc, params, tokens, TRAIN_SEQ, remat=False)
        blocks = {k: torch.as_tensor(v).to(dev) for k, v in tr.pipeline.peek(0).items()}
        loss, grads[mode], _ = tr.gradients(params, blocks)
        first_losses[mode] = float(loss)
        if mode != TRAIN_MODES[0]:
            gap = _grad_gap(grads[mode], grads[TRAIN_MODES[0]])
            del grads[mode]
        else:
            gap = 0.0
        del blocks, loss
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        params, opt, ms, losses, dispatches = _timed_steps(tr, params, opt, TRAIN_STEPS, dev)
        peak = torch.cuda.max_memory_allocated(dev)
        step_ms = statistics.median(ms[2:])
        row = {"phase": "train", "run": f"lm100m/{mode}", "card": card, "params": n_params,
               "tokens_per_step": tokens, "ms_per_step": step_ms,
               "tokens_per_s": tokens / step_ms * 1e3, "dispatches_per_step": sorted(dispatches),
               "peak_memory_gb": peak / 1e9, "first_loss": losses[0], "last_loss": losses[-1],
               "losses": losses, "step_matmul_bound_ms": bound_ms,
               "bound_share": bound_ms / step_ms, "first_step_loss": first_losses[mode],
               "grad_gap_vs_spliter": gap, "step_ms": ms}
        row["profile"] = profile_step(tr, params, opt, tr.pipeline.peek(TRAIN_STEPS), step_ms)
        emit(row)
        want = {"spliter": 1, "per_block": TRAIN_BLOCKS + 1, "materialized": 1}[mode]
        check(dispatches == {want}, f"lm100m/{mode}: dispatches {dispatches}, expected {want}")
        check(all(math.isfinite(x) for x in losses), f"lm100m/{mode}: finite losses")
        check(statistics.mean(losses[-4:]) < statistics.mean(losses[:4]),
              f"lm100m/{mode}: the loss falls ({losses})")
        if mode != TRAIN_MODES[0]:
            check(gap <= TRAIN_GRAD_TOL[mode],
                  f"lm100m/{mode}: gradient gap {gap} > {TRAIN_GRAD_TOL[mode]}")
        del params, opt, tr
        gc.collect()
        torch.cuda.empty_cache()
    del grads
    ref = first_losses[TRAIN_MODES[0]]
    check(all(abs(v - ref) <= TRAIN_LOSS_RTOL * abs(ref) for v in first_losses.values()),
          f"lm100m: first-step losses agree within {TRAIN_LOSS_RTOL}: {first_losses}")

    # ---- resume on the card: lm20m preempted at step 6, restored, finished ----
    m20 = dataclasses.replace(_preset("lm20m"), attn_impl="flash")
    kw20 = dict(global_batch=16, num_blocks=4, seq_len=256, steps=12, peak_lr=1e-3,
                warmup_steps=2, seed=seed)
    (ROOT / "build").mkdir(exist_ok=True)
    ckpt = tempfile.mkdtemp(prefix="train_ckpt_", dir=ROOT / "build")
    try:
        t0 = time.perf_counter()
        full = Trainer(m20, TrainConfig(**kw20), device=dev).run(resume=False)
        guard = PreemptionGuard(install=False)

        def stop_at_6(step, loss):
            if step == 5:
                guard.request_stop()

        first = Trainer(m20, TrainConfig(ckpt_dir=ckpt, **kw20), device=dev).run(
            guard=guard, on_step=stop_at_6)
        resumed = Trainer(m20, TrainConfig(ckpt_dir=ckpt, **kw20), device=dev).run(resume=True)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves((full["params"], full["opt"])),
            tree_leaves((resumed["params"], resumed["opt"]))))
        row = {"phase": "train", "run": "lm20m/resume", "card": card,
               "stopped_at": first["stopped_at"], "finished_at": resumed["stopped_at"],
               "bit_identical_params_and_moments": same,
               "loss_tail_equal": full["losses"][6:] == resumed["losses"],
               "losses": full["losses"], "seconds": time.perf_counter() - t0}
        emit(row)
        check(first["preempted"] and first["stopped_at"] == 6 and resumed["stopped_at"] == 12,
              "lm20m: preempted at 6, finished at 12")
        check(same and row["loss_tail_equal"], "lm20m: resume bit-identical on the card")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del full, first, resumed
    gc.collect()
    torch.cuda.empty_cache()

    # ---- mamba2-1.3b at full width: the chunked SSD route carries the gradient ----
    mamba = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=TRAIN_MAMBA2_LAYERS)
    check(mamba.remat == "full" and 512 % mamba.ssm_chunk == 0 and 512 > mamba.ssm_chunk,
          f"mamba2-1.3b: remat full and the chunked route at 512 ({mamba.remat}, "
          f"{mamba.ssm_chunk})")
    tr = Trainer(mamba, TrainConfig(global_batch=8, num_blocks=2, seq_len=512, steps=3,
                                    peak_lr=1e-4, warmup_steps=2, seed=seed), device=dev)
    params, opt = tr.init_state()
    n_params = sum(t.numel() for t in tree_leaves(params))
    torch.cuda.reset_peak_memory_stats(dev)
    blocks = {k: torch.as_tensor(v).to(dev) for k, v in tr.pipeline.peek(0).items()}
    loss, mgrads, _ = tr.gradients(params, blocks)
    finite = bool(math.isfinite(float(loss))) and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(mgrads))
    nonzero = sum(bool(torch.any(t != 0)) for t in tree_leaves(mgrads))
    n_leaves = len(tree_leaves(mgrads))
    del mgrads, blocks, loss
    params, opt, ms, losses, _ = _timed_steps(tr, params, opt, 3, dev)
    row = {"phase": "train", "run": "mamba2-1.3b", "card": card, "layers": mamba.num_layers,
           "params": n_params,
           "tokens_per_step": 8 * 512, "ms_per_step": ms, "losses": losses,
           "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "finite_loss_and_gradients": finite, "nonzero_gradient_leaves": [nonzero, n_leaves],
           "step_matmul_bound_ms": train_step_bound_ms(mamba, params, 8 * 512, 512, True),
           "ssd_scan_launches": read_launches()["ssd_scan"] - before["ssd_scan"]}
    emit(row)
    check(finite and all(math.isfinite(x) for x in losses), "mamba2-1.3b: finite loss and grads")
    check(nonzero == n_leaves, f"mamba2-1.3b: every gradient leaf non-zero ({nonzero}/{n_leaves})")
    del params, opt, tr
    gc.collect()
    torch.cuda.empty_cache()

    # ---- a witness for mamba2's step at peak lr 1e-3: 2 layers at full width, f32,
    # the card's trajectory against the CPU port's from the same params ----
    m2 = dataclasses.replace(mamba, num_layers=2, dtype="float32")
    kw2 = dict(global_batch=1, num_blocks=1, seq_len=512, steps=WITNESS_STEPS, peak_lr=1e-3,
               warmup_steps=1, seed=seed)
    t0 = time.perf_counter()
    cpu_tr = Trainer(m2, TrainConfig(**kw2), device="cpu")
    card_tr = Trainer(m2, TrainConfig(**kw2), device=dev)
    cpu_p, cpu_o = cpu_tr.init_state()
    card_p, card_o = tree_map(lambda t: t.to(dev), (cpu_p, cpu_o))
    host0 = {k: torch.as_tensor(v) for k, v in cpu_tr.pipeline.peek(0).items()}
    _, cg, _ = cpu_tr.gradients(cpu_p, host0)
    _, gg, _ = card_tr.gradients(card_p, {k: v.to(dev) for k, v in host0.items()})
    grad_gap = _grad_gap(tree_map(lambda t: t.cpu(), gg), cg)
    del cg, gg, host0
    cpu_losses, card_losses = [], []
    for s in range(WITNESS_STEPS):
        cpu_p, cpu_o, loss, _ = cpu_tr.train_step(cpu_p, cpu_o, cpu_tr.pipeline.peek(s))
        cpu_losses.append(float(loss))
        card_p, card_o, loss, _ = card_tr.train_step(card_p, card_o, card_tr.pipeline.peek(s))
        card_losses.append(float(loss))
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    emit({"phase": "train", "run": "mamba2-1.3b/2-layers/lr-1e-3", "card": card,
          "layers": m2.num_layers, "dtype": m2.dtype,
          "tokens_per_step": kw2["global_batch"] * kw2["seq_len"],
          "card_losses": card_losses, "cpu_losses": cpu_losses, "loss_rel_gap": loss_gap,
          "step1_grad_gap": grad_gap, "loss_rtol": WITNESS_LOSS_RTOL,
          "grad_tol": SMOKE_GRAD_TOL, "seconds": time.perf_counter() - t0})
    check(all(math.isfinite(x) for x in card_losses + cpu_losses)
          and loss_gap <= WITNESS_LOSS_RTOL and grad_gap <= SMOKE_GRAD_TOL,
          f"mamba2-1.3b at 2 layers, lr 1e-3: the card's steps against the CPU's "
          f"(losses {card_losses} / {cpu_losses}, gradient gap {grad_gap})")
    del cpu_tr, card_tr, cpu_p, cpu_o, card_p, card_o
    gc.collect()
    torch.cuda.empty_cache()

    # ---- every smoke config: one f32 step on the card against the CPU ----
    worst = {}
    for arch in ARCH_IDS:
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", attn_impl="flash")
        model = build_model(cfg)
        cpu_params = model.init(torch.Generator().manual_seed(seed), device="cpu", master=True)
        set_gates(cpu_params, 0.75)
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab_size, (2, 2, 33)).astype(np.int64)
        blocks = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        if cfg.family == "audio":
            blocks["frames"] = rng.normal(size=(2, 2, cfg.encoder_seq, cfg.d_model))
        if cfg.family == "vlm":
            blocks["image_embeds"] = rng.normal(size=(2, 2, cfg.image_tokens, cfg.image_embed_dim))
        host = {k: torch.from_numpy(np.asarray(v, np.float32) if v.dtype == np.float64 else v)
                for k, v in blocks.items()}
        cl, cg = accumulate_gradients(model.loss, cpu_params, host)
        card_params = tree_map(lambda t: t.to(dev), cpu_params)
        gl, gg = accumulate_gradients(model.loss, card_params, {k: v.to(dev) for k, v in host.items()})
        opt = adamw_init(card_params)
        card_params, opt = adamw_update(card_params, gg, opt, lr=1e-3)
        loss_gap = abs(float(gl) - float(cl)) / abs(float(cl))
        grad_gap = _grad_gap(tree_map(lambda t: t.cpu(), gg), cg)
        worst[arch] = {"loss_rel": loss_gap, "grad_gap": grad_gap,
                       "finite_step": all(bool(torch.isfinite(t).all())
                                          for t in tree_leaves(card_params))}
        check(loss_gap <= SMOKE_LOSS_RTOL and grad_gap <= SMOKE_GRAD_TOL
              and worst[arch]["finite_step"],
              f"{arch}: the card's f32 step against the CPU's {worst[arch]}")
    emit({"phase": "train", "run": "smoke_configs", "card": card, "f32_vs_cpu": worst,
          "loss_rtol": SMOKE_LOSS_RTOL, "grad_tol": SMOKE_GRAD_TOL})

    after = _train_counters()
    launches = {k: after[k] - before[k] for k in after}
    emit({"phase": "train", "run": "launches", "card": card, "launches": launches,
          "route_under_autograd": "plain attention (layers._sdpa_auto) and ssd_chunked: "
                                  "neither kernel has a backward",
          "seconds": time.perf_counter() - t_phase})
    check(all(v == 0 for v in launches.values()),
          f"no kernel launches on the training path: {launches}")
    return launches


#: the distributed phase (single-controller ranks, all on cuda:0).  lm100m's
#: train-phase batch for the sharded step on a (2, 2, 2) mesh, held to the
#: reference's 5e-3 on the loss (tests/_dist_child.py:139); its f32 gradient
#: tree for the collectives on a (2, 4) mesh, the hierarchical psum against
#: the flat one within 1e-6 and 8× the input within 1e-5 (relative, element
#: by element; tests/_dist_child.py:52-55); gpipe over lm100m's 12 layers as
#: 4 stages of 3 on a (4, 2) mesh, 8 microbatches of 8 × 1024 bf16 hidden
#: states, against the layers applied in order within BF16_TOL; the decode
#: paths on qwen3-32b at the serve row's depth (``SERVE_QWEN3_LAYERS``).  The decomposed
#: path against the default one: f32 within F32_LOGIT_TOL (the two differ
#: only in the softmax's association; the reference's smoke test holds 2e-5
#: at width 64), bf16 within the qwen3 serve row's 0.25 (each attention
#: output rounds to bf16 once more: two products summed)
DIST_STEPS, DIST_DECOMPOSED_BF16_TOL = 64, 0.25
DIST_PIPE_STAGES, DIST_MICRO, DIST_MB = 4, 8, 8
DIST_MLA_STEPS = 16


def _wall_ms(fn) -> tuple[float, object]:
    """``fn()``'s result and its wall time ending in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0), out


def _tree_bytes(tree) -> int:
    from repro_torch._pytree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _leading_data_shardings(tree, mesh):
    """Every leaf over ``data`` on its first dim that the axis divides
    (replicated where none does)."""
    from repro_torch._pytree import tree_map
    from repro_torch.distributed import NamedSharding, P

    n = mesh.shape["data"]

    def one(t):
        for d, size in enumerate(t.shape):
            if size % n == 0:
                return NamedSharding(mesh, P(*([None] * d), "data"))
        return NamedSharding(mesh, P())

    return tree_map(one, tree)


def _decode_run(model, params, tokens, cache, rules) -> tuple:
    """One decode step per column of ``tokens`` (B, steps) from the
    prefilled ``cache`` (a copy of it is written), the same tokens on every
    path, under ``rules``: the logits (B, steps, V), the ms per step and the
    final cache."""
    from repro_torch._pytree import tree_map
    from repro_torch.distributed.sharding import use_rules

    cache = tree_map(torch.clone, cache)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad(), use_rules(rules):
        for t in range(tokens.shape[1]):
            logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                              SERVE_PROMPT + t)
            out.append(logits)
    torch.cuda.synchronize()
    return torch.stack(out, 1), 1e3 * (time.perf_counter() - t0) / tokens.shape[1], cache


def _prefilled(arch: str, overrides: dict, dtype: str, seed: int, dev, steps: int) -> tuple:
    """The config at full width (``overrides`` cut depth), random params from
    ``seed`` in ``dtype``, a cache holding the prefill of a batch of
    SERVE_PROMPT-token prompts, and the (B, steps) tokens every decode path
    is fed."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), dtype=dtype, **overrides)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT + steps), dtype=np.int64), device=dev)
    cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT + steps, dtype=getattr(torch, dtype),
                             device=dev)
    with torch.no_grad():
        model.prefill(params, {"tokens": toks[:, :SERVE_PROMPT]}, cache)
    return model, params, toks[:, SERVE_PROMPT:], cache


def distributed_phase(seed: int, dev: torch.device, card: str) -> dict:
    """The distribution substrate on the card (``repro_torch.distributed``,
    ``launch/mesh.py``): every rank a position on ``dev``."""
    import dataclasses
    import tempfile

    from repro_torch._pytree import tree_leaves, tree_map
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import (
        P,
        compressed_psum_pod,
        data_parallel_gradients,
        decode_rules,
        decode_rules_headsharded,
        device_put,
        gpipe,
        params_shardings,
        psum,
        psum_pod_hierarchical,
        shard_map,
        sharded_train_step,
    )
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.train import _preset
    from repro_torch.models import build_model
    from repro_torch.models.lm import _apply_layer
    from repro_torch.optim import accumulate_gradients, adamw_update
    from repro_torch.runtime import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    t_phase = time.perf_counter()
    mesh_of = lambda shape, axes: compat_make_mesh(shape, axes, devices=(dev,))  # noqa: E731

    # ---- rank threads: why the ranks take turns and the threads are kept ----
    cache_row = torch.zeros((SERVE_BATCH, 8, 128), device=dev, dtype=torch.bfloat16)

    def ops(n=50):
        for _ in range(n):
            cache_row[:, 3].fill_(1)

    def threads_of(target):
        threads = [threading.Thread(target=target) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    mesh_8 = mesh_of((8,), ("data",))
    turns = shard_map(lambda: ops(), mesh=mesh_8, in_specs=(), out_specs=None)
    empty = shard_map(lambda: None, mesh=mesh_8, in_specs=(), out_specs=None)
    rows = {}
    for name, fn in (("one_thread_ms", lambda: ops(400)),
                     ("eight_threads_at_once_ms", lambda: threads_of(ops)),
                     ("shard_map_turns_ms", turns), ("shard_map_empty_ms", empty),
                     ("start_8_threads_ms", lambda: threads_of(lambda: None))):
        fn()
        rows[name] = statistics.median(_wall_ms(fn)[0] for _ in range(20))
    emit({"phase": "distributed", "run": "rank_threads", "card": card,
          "ops": "400 one-row fills of a bf16 (8, 8, 128) tensor: by one thread, by 8 "
                 "threads at once (50 each), by 8 shard_map ranks in turn (50 each)",
          **rows})

    # ---- sharded_train: lm100m whole, one step on (pod, data, model) = (2, 2, 2) ----
    mc = dataclasses.replace(_preset("lm100m"), attn_impl="flash")
    tr = Trainer(mc, TrainConfig(global_batch=TRAIN_BATCH, num_blocks=TRAIN_BLOCKS,
                                 seq_len=TRAIN_SEQ, steps=TRAIN_STEPS, seed=seed), device=dev)
    params, opt = tr.init_state()
    blocks = {k: torch.as_tensor(v).to(dev) for k, v in tr.pipeline.peek(0).items()}
    loss_fn = tr.model.loss
    accumulate_gradients(loss_fn, params, blocks)  # warm-up
    p_copy, o_copy = tree_map(torch.clone, params), tree_map(torch.clone, opt)

    def unsharded_step():
        loss, grads = accumulate_gradients(loss_fn, params, blocks)
        adamw_update(p_copy, grads, o_copy, lr=1e-3)
        return loss, grads

    plain_ms, (loss_ref, grads_ref) = _wall_ms(unsharded_step)
    del p_copy, o_copy
    mesh3 = mesh_of((2, 2, 2), ("pod", "data", "model"))
    placed = device_put(params, params_shardings(params, mesh3))
    torch.cuda.reset_peak_memory_stats(dev)
    dp_ms, (loss_dp, grads_dp) = _wall_ms(lambda: data_parallel_gradients(
        loss_fn, placed, blocks, mesh=mesh3))
    dp_peak = torch.cuda.max_memory_allocated(dev)
    grad_gap = _grad_gap(grads_dp, grads_ref)
    del grads_dp
    sharded_ms, (placed, opt, loss) = _wall_ms(lambda: sharded_train_step(
        loss_fn, placed, opt, blocks, mesh=mesh3, lr=1e-3))
    loss_gap = abs(float(loss) - float(loss_ref))
    emit({"phase": "distributed", "run": "sharded_train", "card": card, "mesh": mesh3.shape,
          "params": sum(t.numel() for t in tree_leaves(params)),
          "tokens": TRAIN_BATCH * TRAIN_SEQ, "loss": float(loss),
          "unsharded_loss": float(loss_ref), "loss_gap": loss_gap,
          "loss_gap_dp_grads_only": abs(float(loss_dp) - float(loss_ref)),
          "grad_gap_vs_unsharded": grad_gap, "ms_per_step": sharded_ms,
          "dp_gradients_first_call_ms": dp_ms, "dp_peak_memory_gb": dp_peak / 1e9,
          "unsharded_step_ms": plain_ms,
          "tensor_parallel": "not emulated: the model ranks of a (pod, data) position "
                             "compute the same gradients"})
    check(loss_gap <= 5e-3, f"sharded_train: loss {float(loss)} vs unsharded "
          f"{float(loss_ref)}")
    check(all(a.sharding == b.sharding for a, b in zip(
        tree_leaves(placed), tree_leaves(device_put(params, params_shardings(params, mesh3))))),
        "sharded_train: the params keep their layouts")

    # ---- collectives: the f32 gradient tree on (pod, data) = (2, 4) ----
    mesh24 = mesh_of((2, 4), ("pod", "data"))
    grads = grads_ref
    nbytes = _tree_bytes(grads)
    flat_psum = shard_map(lambda t: psum(t, ("pod", "data")), mesh=mesh24, in_specs=(P(),),
                          out_specs=P(), check_vma=False)
    psum_pod_hierarchical(grads, mesh24)  # warm-up
    copy_ms, copies = _wall_ms(lambda: tree_map(torch.clone, grads))
    del copies
    hier_ms, hier = _wall_ms(lambda: psum_pod_hierarchical(grads, mesh24))
    hier_again_ms, hier_again = _wall_ms(lambda: psum_pod_hierarchical(grads, mesh24))
    flat_ms, flat = _wall_ms(lambda: flat_psum(grads))
    identical = all(torch.equal(a, b) for a, b in zip(tree_leaves(hier), tree_leaves(hier_again)))
    vs_flat = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                  for a, b in zip(tree_leaves(hier), tree_leaves(flat)) if b.numel())
    vs_8x = max(float(((a - 8 * g).abs() / (8 * g).abs().clamp(min=1e-30)).max())
                for a, g in zip(tree_leaves(hier), tree_leaves(grads)) if g.numel())
    del hier, hier_again, flat
    big = max(tree_leaves(grads), key=lambda t: t.numel())
    comp = shard_map(lambda v: compressed_psum_pod(v, fast_axis="data", slow_axis="pod"),
                     mesh=mesh24, in_specs=(P(),), out_specs=P(), check_vma=False)
    comp(big)
    comp_ms, got = _wall_ms(lambda: comp(big))
    want = 8 * big
    # the bound of tests/_dist_child.py:65 over the quantization's rows: one
    # scale per index of the leading dim (per row of a 2-d leaf)
    rows = want.reshape(want.shape[0], -1)
    bound_rows = 2 * (rows.abs().amax(-1, keepdim=True) / 127.0) * 1.01 + 1e-6
    comp_ok = bool(((got.reshape(rows.shape) - rows).abs() <= bound_rows).all())
    comp_err = float((got - want).abs().max())
    emit({"phase": "distributed", "run": "collectives", "card": card, "mesh": mesh24.shape,
          "leaves": len(tree_leaves(grads)), "bytes": nbytes,
          "hierarchical_ms": hier_ms, "hierarchical_again_ms": hier_again_ms,
          "flat_ms": flat_ms, "clone_ms": copy_ms,
          "hierarchical_GBps": nbytes / hier_ms / 1e6, "flat_GBps": nbytes / flat_ms / 1e6,
          "clone_GBps": nbytes / copy_ms / 1e6,
          "hierarchical_vs_flat_rel": vs_flat, "hierarchical_vs_8x_rel": vs_8x,
          "runs_bit_identical": identical, "compressed_leaf": list(big.shape),
          "compressed_ms": comp_ms, "compressed_GBps": big.numel() * 4 / comp_ms / 1e6,
          "compressed_max_err": comp_err, "compressed_within_int8_bound": comp_ok})
    check(vs_flat <= 1e-6, f"collectives: hierarchical vs flat psum {vs_flat} > 1e-6")
    check(vs_8x <= 1e-5, f"collectives: hierarchical vs 8x the input {vs_8x} > 1e-5")
    check(identical, "collectives: two hierarchical runs are bit-identical")
    check(comp_ok, f"collectives: compressed psum within the int8 bound ({comp_err})")
    del got, want, rows, bound_rows, grads, grads_ref

    # ---- elastic_restore: params and AdamW moments saved from (8,), restored onto (2,) ----
    mesh8, mesh2 = mesh_of((8,), ("data",)), mesh_of((2,), ("data",))
    state = (params, opt)
    saved = device_put(state, _leading_data_shardings(state, mesh8))
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        save_ms, _ = _wall_ms(lambda: ck.save(1, saved, blocking=True))
        del saved
        template = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), state)
        restore_ms, (restored, _, step) = _wall_ms(lambda: ck.restore(
            template, shardings=_leading_data_shardings(state, mesh2)))
    equal = all(torch.equal(r.full(), t) for r, t in zip(tree_leaves(restored),
                                                           tree_leaves(state)))
    devices = {r.sharding.num_devices for r in tree_leaves(restored)}
    emit({"phase": "distributed", "run": "elastic_restore", "card": card,
          "bytes": _tree_bytes(state), "leaves": len(tree_leaves(state)),
          "save_s": save_ms / 1e3, "restore_s": restore_ms / 1e3, "bit_equal": equal,
          "num_devices": sorted(devices)})
    check(step == 1 and equal, "elastic_restore: the restored params and moments are bit-equal")
    check(devices == {2}, f"elastic_restore: restored onto 2 ranks ({devices})")
    del restored, state, params, opt, placed, tr, blocks
    gc.collect()
    torch.cuda.empty_cache()

    # ---- gpipe: lm100m's 12 layers as 4 stages of 3 on (pipe, data) = (4, 2) ----
    cfg = dataclasses.replace(mc, dtype="bfloat16")
    lm = build_model(cfg)
    weights = lm.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    ((spec,),) = (seg.period for seg in cfg.segments())
    per = cfg.num_layers // DIST_PIPE_STAGES
    stages = tree_map(lambda t: t.reshape(DIST_PIPE_STAGES, per, *t.shape[1:]), weights["seg0"])
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    xs = torch.randn((DIST_MICRO, DIST_MB, TRAIN_SEQ, cfg.d_model), generator=g, device=dev,
                     dtype=torch.bfloat16)
    ctx = {"positions": torch.arange(TRAIN_SEQ, device=dev).expand(DIST_MB, TRAIN_SEQ)}

    def stage_fn(p, x):
        for i in range(per):
            x = _apply_layer(tree_map(lambda t: t[i], p)[0], spec, cfg, x, ctx, None)
        return x

    mesh_pipe = mesh_of((DIST_PIPE_STAGES, 2), ("pipe", "data"))
    before = read_launches()["flash_attention"]
    with torch.no_grad():
        gpipe_ms, piped = _wall_ms(lambda: gpipe(stage_fn, stages, xs, mesh=mesh_pipe))
    gpipe_launches = read_launches()["flash_attention"] - before
    saved_counts = read_launches()
    with torch.no_grad():  # the comparison run launches off the count
        seq_ms, sequential = _wall_ms(lambda: torch.stack(
            [_layers_in_order(stage_fn, stages, x) for x in xs]))
    for name, fn in kernel_counters().items():
        fn.launches = saved_counts[name]
    gap = float((piped.float() - sequential.float()).abs().max())
    ticks = DIST_MICRO + DIST_PIPE_STAGES - 1
    want_launches = mesh_pipe.size * ticks * per
    emit({"phase": "distributed", "run": "gpipe", "card": card, "mesh": mesh_pipe.shape,
          "stages": DIST_PIPE_STAGES, "layers_per_stage": per, "microbatches": DIST_MICRO,
          "microbatch": [DIST_MB, TRAIN_SEQ, cfg.d_model], "dtype": "bfloat16",
          "ms": gpipe_ms, "sequential_ms": seq_ms,
          "ticks_over_microbatches": ticks / DIST_MICRO,
          "flash_launches": gpipe_launches, "flash_launches_expected": want_launches,
          "max_abs_err_vs_sequential": gap, "bit_identical": bool(torch.equal(piped, sequential)),
          "tol": BF16_TOL})
    check(gpipe_launches == want_launches,
          f"gpipe: flash_attention launches {gpipe_launches} != {want_launches}")
    check(bool(torch.allclose(piped.float(), sequential.float(), **BF16_TOL)),
          f"gpipe: the pipeline against the layers in order ({gap})")
    del lm, weights, stages, xs, piped, sequential
    gc.collect()
    torch.cuda.empty_cache()

    # ---- decode paths ----
    qwen = SERVE["qwen3-32b"]["overrides"]
    mesh11 = mesh_of((1, 1), ("data", "model"))
    mesh_dm = mesh_of((2, 4), ("data", "model"))
    for dtype in ("bfloat16", "float32"):
        model, params, toks, cache = _prefilled("qwen3-32b", qwen, dtype, seed, dev, DIST_STEPS)
        _decode_run(model, params, toks[:, :2], cache, None)  # warm-up
        base, base_ms, base_cache = _decode_run(model, params, toks, cache, None)
        rules = dataclasses.replace(decode_rules(mesh11), cache_impl="decomposed")
        dec, dec_ms, _ = _decode_run(model, params, toks, cache, rules)
        v = model.cfg.vocab_size
        err = float((dec[..., :v].float() - base[..., :v].float()).abs().max())
        tol = DIST_DECOMPOSED_BF16_TOL if dtype == "bfloat16" else F32_LOGIT_TOL
        emit({"phase": "distributed", "run": f"decode/decomposed/{dtype}", "card": card,
              "arch": "qwen3-32b", "layers": model.cfg.num_layers, "batch": SERVE_BATCH,
              "prompt": SERVE_PROMPT, "steps": DIST_STEPS, "mesh": mesh11.shape,
              "decode_ms_per_step": dec_ms, "default_decode_ms_per_step": base_ms,
              "max_abs_err_vs_default": err,
              "logit_max_abs": float(base[..., :v].float().abs().max()), "tol": tol})
        check(err <= tol, f"decode/decomposed/{dtype}: {err} > {tol}")
        if dtype == "bfloat16":
            _sharded_decode_row("qwen3-32b", model, params, toks, cache, base, base_ms,
                                base_cache, dataclasses.replace(decode_rules(mesh_dm),
                                                                cache_impl="sharded_dus"), card)
        del model, params, cache, base, dec, base_cache
        gc.collect()
        torch.cuda.empty_cache()
    for arch, layers, rules in (
        ("deepseek-7b", 2, decode_rules_headsharded(mesh_dm)),
        ("deepseek-v2-236b", 2, dataclasses.replace(decode_rules(mesh_dm),
                                                    cache_impl="sharded_dus")),
    ):
        over = {"num_layers": layers, "attn_impl": "flash" if arch == "deepseek-7b" else "ref"}
        model, params, toks, cache = _prefilled(arch, over, "bfloat16", seed, dev, DIST_MLA_STEPS)
        _decode_run(model, params, toks[:, :2], cache, None)  # warm-up
        base, base_ms, base_cache = _decode_run(model, params, toks, cache, None)
        _sharded_decode_row(arch, model, params, toks, cache, base, base_ms, base_cache,
                            rules, card)
        del model, params, cache, base, base_cache
        gc.collect()
        torch.cuda.empty_cache()

    launches = read_launches()
    emit({"phase": "distributed", "run": "launches", "card": card, "launches": launches,
          "gpipe_flash_launches": gpipe_launches, "seconds": time.perf_counter() - t_phase})
    check(launches["flash_attention"] > 0, f"distributed: flash_attention launched ({launches})")
    return launches


def _layers_in_order(stage_fn, stages, x):
    """The stages' layers applied to ``x`` one stage after another."""
    from repro_torch._pytree import tree_leaves, tree_map

    for s in range(tree_leaves(stages)[0].shape[0]):
        x = stage_fn(tree_map(lambda t: t[s], stages), x)
    return x


def _sharded_decode_row(arch, model, params, toks, cache, base, base_ms, base_cache, rules,
                        card: str) -> None:
    """The decode under ``rules`` (a (2, 4) mesh) against the default path's
    ``base`` logits and final cache: bit-equal."""
    from repro_torch._pytree import tree_leaves

    steps = toks.shape[1]
    got, ms, got_cache = _decode_run(model, params, toks, cache, rules)
    same_logits = bool(torch.equal(got, base))
    same_cache = all(torch.equal(a, b) for a, b in zip(tree_leaves(got_cache),
                                                        tree_leaves(base_cache)))
    writes = 2 * model.cfg.num_layers * steps if rules.cache_impl == "sharded_dus" else 0
    emit({"phase": "distributed", "run": f"decode/{rules.cache_impl}/{arch}", "card": card,
          "layers": model.cfg.num_layers, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
          "steps": steps, "mesh": rules.mesh.shape, "cache_impl": rules.cache_impl,
          "decode_ms_per_step": ms, "default_decode_ms_per_step": base_ms,
          "shard_map_writes": writes,
          "overhead_ms_per_shard_map_write": (ms - base_ms) * steps / writes if writes else None,
          "logits_bit_equal": same_logits, "caches_bit_equal": same_cache})
    check(same_logits and same_cache,
          f"decode/{rules.cache_impl}/{arch}: logits and caches bit-equal to the default path")


# ---------------------------------------------------------------------------
# tensor_parallel: the serving path split over model
# ---------------------------------------------------------------------------

#: the configs at full width (bf16, flash), random weights from the seed; per
#: mesh of (data, model) positions on the card, the layers each keeps and the
#: bf16 run's greedy decode steps.  qwen3-32b: (1, 4) at 8 layers (the 8 kv
#: heads split 2 a rank) and (1, 16) at 2 layers, the production model axis
#: (make_production_mesh), where 8 kv heads do not divide 16 and wk/wv stay
#: replicated.  mamba2-1.3b: cut to 8 of 48 layers at (1, 4) and 4 at
#: (1, 16) (its 64 SSM heads 16 a rank, then 4; cut for the script's time
#: limit).  jamba-v0.1-52b: one period at
#: both (7 mamba2 layers of 128 heads, one attention layer, 4 MoE layers of
#: 16 experts: 4 a rank, then 1).  mixtral-8x7b: 2 layers (16 virtual
#: half-width experts: 4 a rank, then 1; its 4096-token window wider than
#: the cached tokens).  deepseek-v2-236b: 2 layers, the dense first and one
#: MoE layer (its 128 MLA heads 32 a rank, then 8; the latent cache's 512
#: columns 128 and 32 a rank under the heads layout; 160 experts 40, then
#: 10).  whisper-tiny whole (4 encoder and 4 decoder layers; 6 heads divide
#: neither axis: every rank computes the attention whole, its MLP columns
#: split), fed 8 × 1500 frames.  llama-3.2-vision-11b: one period of 5
#: layers (4 self-attention, 1 cross-attention to 1600 image tokens of
#: 4096, which every decode step gets again, as the reference's server
#: passes them; 8 kv heads 2 a rank, replicated at 16).  Every cross
#: layer's gate is CROSS_GATE.  The bf16 runs take 4 greedy decode steps
#: (cut for the script's time limit); at (1, 16) the
#: SSM, MoE, MLA and cross-attention configs take 2, and their f32 runs
#: too: each step's host work grows with ranks × layers (the ranks take
#: turns on one card), and the prefill and a step already run every
#: collective.  Each mesh
#: runs the prefill of 8 512-token prompts and the steps under
#: decode_rules (the cache's sequence over model:
#: context-parallel decode) and decode_rules_headsharded (cache_impl
#: "heads_dus": its kv heads over model), against the unsharded
#: Model.prefill / decode_step on the same weights, fed the unsharded run's
#: greedy tokens: first in f32 (TP_F32_STEPS steps), the correctness check
#: of every config, logits and cache within F32_LOGIT_TOL and the MoE routes
#: the unsharded f32 run's but for at most F32_ROUTE_FLIPS (layer, token)
#: pairs; then in bf16 (each row prints the unsharded bf16 run's distance
#: from the unsharded f32 run).  The unsharded runs come first; their
#: params are then placed leaf by leaf, each whole leaf freed as its shards are made, so that
#: the card holds one copy (jamba's 26.5 GB in bf16, 53 GB in f32).  The bf16
#: logits of the dense config differ by rounding only: each rank's partial
#: products of wo and w_down round to bf16 before the ranks sum them, and
#: the decode combine sums in f32 where the unsharded softmax rounds its
#: probabilities to bf16; the tolerance is the qwen3 serve row's (0.25 at 8
#: layers), as for the decomposed decode.  The same holds for whisper's and
#: the vlm's attention, MLA-free and MoE-free.  With SSM or MoE layers the bf16
#: errors are printed, not judged: the unsharded bf16 model is itself 1.47
#: (mamba2-1.3b at 48 layers) to 2.30 (mixtral-8x7b,
#: routes flipped at earlier positions) from its f32 run on an H100 (700 W), of logits of about 5, so
#: no bf16 bound there could tell a wrong program from rounding; their f32
#: check is the one that decides.  The card holds every rank's activations,
#: so the prefill's peak memory rise counts the residual stream once a rank
#: (each card of a real mesh would hold one); the rows print it whole.
TP_RUNS = {
    "qwen3-32b": {(1, 4): (8, 4), (1, 16): (2, 4)},
    "mamba2-1.3b": {(1, 4): (8, 4), (1, 16): (4, 2)},
    "jamba-v0.1-52b": {(1, 4): (8, 4), (1, 16): (8, 2)},
    "mixtral-8x7b": {(1, 4): (2, 4), (1, 16): (2, 2)},
    "deepseek-v2-236b": {(1, 4): (2, 4), (1, 16): (2, 2)},
    "whisper-tiny": {(1, 4): (4, 4), (1, 16): (4, 2)},
    "llama-3.2-vision-11b": {(1, 4): (5, 4), (1, 16): (5, 2)},
}
TP_F32_STEPS = 4
#: the MoE routes of a tensor-parallel f32 run may differ from the
#: unsharded f32 run's at this many (layer, token) pairs in all: a near-tie
#: of router logits that float reassociation tips (jamba-v0.1-52b showed one
#: of 16,896 on an H100); a wrong dispatch would move far more
F32_ROUTE_FLIPS = 4
#: a route flip is at a near-tie where the unsharded f32 run's router margin
#: there (the k-th minus the (k+1)-th router logit) is below this: ten times
#: the distance of the two programs' f32 logits (1e-4).  The long_decode
#: phase holds its f32 runs to F32_ROUTE_FLIPS near-ties, its first flip at
#: one (a flip moves every later position through the SSM state and the
#: attention rows, so the flips after it may be clear of a tie)
ROUTE_NEAR_TIE = 1e-3
TP_BF16_TOL = 0.25
#: the flash kernel at the shapes a tensor-parallel rank launches it:
#: label -> (H, Hkv, window, memory) of q (8, 512, H, 128) and k/v (8, L,
#: Hkv, 128): causal over the prompt (L 512) where memory is 0, else not
#: causal over L = memory rows.  mixtral's and jamba's 32 q heads and 8 kv
#: heads give the same shapes (mixtral's window of 4096 masks nothing of a
#: 512-token prompt), as does the vlm's self-attention; the vlm's cross
#: layer reads 2 of its 8 kv heads at (1, 4) and 1 of the 8, replicated,
#: at (1, 16).  Whisper's 6 heads divide neither axis: its ranks launch the
#: kernel at the whole layer's shapes (CROSS_FLASH_SHAPES)
TP_FLASH_SHAPES = {"rank_of_4": (16, 2, 0, 0), "rank_of_16": (4, 1, 0, 0),
                   "mixtral_jamba_rank_of_4": (8, 2, 4096, 0),
                   "mixtral_jamba_rank_of_16": (2, 1, 4096, 0),
                   "vlm_cross_rank_of_4": (8, 2, 0, 1600),
                   "vlm_cross_rank_of_16": (2, 1, 0, 1600)}
#: the SSD kernel at a rank's heads: label -> (heads, state), x (8, 512,
#: heads, 64): mamba2-1.3b's 64 heads over 4 and 16 ranks, jamba's 128
TP_SSD_SHAPES = {"mamba2_rank_of_4": (16, 128), "mamba2_rank_of_16": (4, 128),
                 "jamba_rank_of_4": (32, 16), "jamba_rank_of_16": (8, 16)}


def _tp_rank_param_bytes(cfg, n: int) -> int:
    """Closed form of one rank's parameter bytes (bf16 products, biases,
    gates; f32 norms, ``A_log`` and ``dt_bias``) on a model axis of ``n``,
    as ``params_shardings`` lays them out: the vocabulary (a tied head's
    ``embed`` once), the q heads (MLA's ``wq_b``, ``wk_b`` and ``wv_b`` by
    heads), the MLP columns (``dense_d_ff`` in deepseek-v2's dense layer,
    the shared experts' ``s·F``), the SSM heads and the (virtual) experts
    split n ways where n divides them, else whole, as are the kv heads
    (cross-attention's ``wk_mem``/``wv_mem`` too); the SSM's B/C
    projections and convolutions, MLA's ``wq_a`` and ``wkv_a``, the router
    and every norm whole; the encoder's layers as the decoder's."""
    d, dh, h, hkv = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    norm = 2 if cfg.norm == "layernorm" else 1  # a weight, and a bias for layernorm

    def part(width: int) -> int:  # a dim split n ways where n divides it
        return width // n if width % n == 0 else width

    bf16 = part(cfg.padded_vocab) * d * (1 if cfg.tie_embeddings else 2)  # embed, lm_head
    f32 = norm * d * (2 if cfg.encoder_layers else 1)  # the final norms
    for seg in (*cfg.segments(), *cfg.encoder_segments()):
        for spec in seg.period:
            r = seg.repeats
            ln2 = spec.mlp != "none" and not cfg.parallel_block
            f32 += r * norm * d * (2 if ln2 else 1)  # ln1, ln2
            if spec.mixer in ("attn", "enc_attn", "cross_attn"):
                mem_d = cfg.image_embed_dim if (spec.mixer == "cross_attn"
                                                and cfg.family == "vlm") else d
                bf16 += r * (2 * d * part(h) * dh + 2 * mem_d * part(hkv) * dh)
                if cfg.qkv_bias and spec.mixer != "cross_attn":
                    bf16 += r * (part(h) + 2 * part(hkv)) * dh
                bf16 += r if spec.mixer == "cross_attn" else 0  # the gate
                f32 += r * 2 * dh if cfg.qk_norm else 0
            elif spec.mixer == "mla":
                kr, qr, rh = cfg.kv_lora_rank, cfg.q_lora_rank, cfg.rope_head_dim
                bf16 += r * ((d * qr if qr else 0) + (qr or d) * part(h) * (dh + rh)
                             + d * (kr + rh) + 2 * kr * part(h) * dh + part(h) * dh * d)
                f32 += r * (qr + kr)  # q_norm_a, kv_norm_a
            else:  # mamba2
                din, nn, w = cfg.ssm_expand * d, cfg.ssm_state, cfg.ssm_conv_width
                nh = din // cfg.ssm_head_dim
                bf16 += r * (3 * d * part(din) + 2 * d * nn + d * part(nh) + w * part(din)
                             + 2 * w * nn + part(nh))
                f32 += r * (2 * part(nh) + part(din))
            if spec.mlp == "dense":
                bf16 += r * 3 * d * part(cfg.dense_d_ff or cfg.d_ff)
            elif spec.mlp == "moe":
                vs = cfg.moe_virtual_split
                bf16 += r * (d * cfg.moe_experts
                             + 3 * part(cfg.moe_experts * vs) * d * (cfg.moe_d_ff // vs))
                if cfg.moe_shared_experts:
                    bf16 += r * 3 * d * part(cfg.moe_shared_experts * cfg.moe_d_ff)
    return 2 * bf16 + 4 * f32


def _place_consuming(tree, shardings):
    """``tree``'s tensor leaves placed by ``shardings`` in its own dicts,
    each whole leaf dropped as soon as its shards are made (a leaf is freed
    then if nothing else holds it); returns ``tree``.  The ranks that hold
    the same block of a weight (its copies over ``data``) share one tensor
    on the card, as each card of a real mesh holds one: the params are only
    read."""
    from repro_torch.distributed import ShardedTensor

    for key in (tree.keys() if isinstance(tree, dict) else range(len(tree))):
        leaf, sh = tree[key], shardings[key]
        if isinstance(leaf, torch.Tensor):
            tree[key] = None
            blocks, shards = {}, []
            for r, d in enumerate(sh.mesh.device_list):
                index = sh.index(r, leaf.shape)
                at = (tuple((i.start, i.stop) for i in index), d)
                if at not in blocks:
                    blocks[at] = leaf[index].to(d, copy=True)
                shards.append(blocks[at])
            tree[key] = ShardedTensor(leaf.shape, sh, shards)
            del leaf, blocks
        else:
            _place_consuming(leaf, sh)
    return tree


def _greedy_run(prefill, decode, toks, steps: int, start: int = SERVE_PROMPT) -> tuple:
    """``prefill()``'s logits, then ``steps`` decode steps ``decode(token,
    pos)`` at positions from ``start`` (the prompt's length) fed ``toks``
    (B, steps) or, where ``toks`` is None, each step's own argmax: the
    logits (B, 1 + steps, Vp), the fed tokens, the prefill's ms and its
    peak memory rise, and the ms per decode step."""
    (prefill_ms, logits), rise = _peak_rise(lambda: _wall_ms(prefill))
    out, fed = [logits], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps):
        tok = out[-1].argmax(-1, keepdim=True) if toks is None else toks[:, t:t + 1]
        fed.append(tok)
        out.append(decode(tok, start + t))
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t0) / steps
    return torch.stack(out, 1), torch.cat(fed, 1), prefill_ms, rise, decode_ms


def tensor_parallel_phase(seed: int, dev: torch.device, card: str) -> dict:
    """The serving path tensor-parallel over ``model``
    (``repro_torch.distributed.sharded_prefill`` / ``sharded_decode_step``),
    every rank a position on ``dev``, against the unsharded model: every
    config and mesh of ``TP_RUNS``."""
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    totals = {k: 0 for k in read_launches()}
    seconds = {}
    for arch, meshes in TP_RUNS.items():
        for shape, (layers, steps) in meshes.items():
            t0 = time.perf_counter()
            for k, c in _tensor_parallel_rows(arch, shape, layers, steps, seed, dev,
                                              card).items():
                totals[k] += c
            seconds[f"{arch}/{shape[0]}x{shape[1]}"] = time.perf_counter() - t0
    emit({"phase": "tensor_parallel", "run": "launches", "card": card, "launches": totals,
          "seconds": time.perf_counter() - t_phase, "seconds_by_run": seconds})
    check(totals["flash_attention"] > 0 and totals["ssd_scan"] > 0,
          f"tensor_parallel: flash_attention and ssd_scan launched ({totals})")
    return totals


def _tensor_parallel_rows(arch: str, shape: tuple, layers: int, steps: int, seed: int,
                          dev: torch.device, card: str) -> dict:
    """One config on one mesh (``tensor_parallel_phase``): the unsharded
    model in bf16 and on the same weights upcast to f32, then the
    tensor-parallel f32 runs and the bf16 runs under both rule sets; emits
    a row per run, checks it, and returns the kernels' launches of the bf16
    runs."""
    import dataclasses

    import numpy as np

    from repro_torch._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.distributed import (
        cache_shardings,
        decode_rules,
        decode_rules_headsharded,
        device_put,
        params_shardings,
        sharded_decode_step,
        sharded_prefill,
    )
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import build_model

    n = shape[1]
    # the cache's rows a multiple of the model axis, so that the seq layout splits them
    max_len = -(-(SERVE_PROMPT + steps) // n) * n
    f32_steps = min(TP_F32_STEPS, steps)
    cfg = dataclasses.replace(get_config(arch), num_layers=layers, attn_impl="flash")
    counts = layer_counts(cfg)
    moe_layers = counts.get("moe", 0)
    dense_only = not moe_layers and not counts.get("mamba2")
    models = {"bf16": build_model(cfg), "f32": build_model(dataclasses.replace(cfg,
                                                                                dtype="float32"))}
    cache_dtype = {"bf16": torch.bfloat16, "f32": torch.float32}
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int64), device=dev)
    v = cfg.vocab_size
    mesh = compat_make_mesh(shape, ("data", "model"), devices=(dev,))
    layouts = (("seq", decode_rules(mesh)), ("heads", decode_rules_headsharded(mesh)))
    name = f"{arch}/{shape[0]}x{shape[1]}"
    prompt_attention = sum(counts.get(m, 0) for m in ("attn", "enc_attn", "cross_attn"))
    expected = {"flash_attention": mesh.size * prompt_attention,
                "ssd_scan": mesh.size * counts.get("mamba2", 0)}
    # whisper's frames or the vlm's image embeddings, and the vlm's decode steps' memory
    extras = {"bf16": cross_extras(cfg, seed, dev)}
    extras["f32"] = {k: t.float() for k, t in extras["bf16"].items()}
    memory = {kind: ex.get("image_embeds") for kind, ex in extras.items()}

    def init():
        params = models["bf16"].init(torch.Generator(device=dev).manual_seed(seed), device=dev)
        set_gates(params, CROSS_GATE)
        return params

    def recorded(fn):  # fn()'s result and the MoE routes it recorded (None: no MoE)
        return _recording_routes(fn) if moe_layers else (fn(), None)

    def unsharded(params, kind, toks, steps=steps):
        model, batch, mem = models[kind], {"tokens": prompts, **extras[kind]}, memory[kind]
        cache = model.init_cache(SERVE_BATCH, max_len, dtype=cache_dtype[kind], device=dev)
        with torch.no_grad():
            return _greedy_run(lambda: model.prefill(params, batch, cache)[0],
                               lambda tok, pos: model.decode_step(params, cache, tok, pos,
                                                                  mem)[0],
                               toks, steps) + (cache,)

    def sharded(placed, kind, rules, layout, toks, steps=steps):
        model, batch, mem = models[kind], {"tokens": prompts, **extras[kind]}, memory[kind]
        c0 = model.init_cache(SERVE_BATCH, max_len, dtype=cache_dtype[kind], device=dev)
        cache = device_put(c0, cache_shardings(c0, mesh, layout=layout))
        del c0
        with torch.no_grad():
            return _greedy_run(
                lambda: sharded_prefill(model, placed, batch, cache, mesh=mesh, rules=rules)[0],
                lambda tok, pos: sharded_decode_step(model, placed, cache, tok, pos, mem,
                                                     mesh=mesh, rules=rules)[0],
                toks, steps) + (cache,)

    def compare(got, base, got_routes, base_routes):
        """(B, 1 + steps) errors of the logits, the positions held (their
        routes agree in every MoE layer) and the routes' mismatches a layer."""
        err = (got[..., :v].float() - base[..., :v].float()).abs().amax(-1)
        if not moe_layers:
            return err, torch.ones_like(err, dtype=torch.bool), None
        flips = _route_flips(_per_layer(base_routes, moe_layers),
                             _per_layer(got_routes, moe_layers))  # (layers, B, positions)
        at = SERVE_PROMPT - 1 + torch.arange(got.shape[1], device=dev)  # the logits' positions
        return err, ~flips[:, :, at].any(0), [int(f.sum()) for f in flips]

    def held_max(err, held):
        return float(err[held].max()) if held.any() else None

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # ---- the unsharded model: bf16, then f32 on the same weights upcast ----
    params = init()
    whole_bytes = _tree_bytes(params)
    unsharded(params, "bf16", None, steps=1)  # warm-up
    reset_launches()
    (base, toks, base_prefill_ms, base_rise, base_decode_ms, base_cache), base_routes = \
        recorded(lambda: unsharded(params, "bf16", None))
    torch.cuda.synchronize()
    base_launches = read_launches()
    upcast_in_place(params)
    free()
    (base32, _, _, _, _, base32_cache), base32_routes = recorded(
        lambda: unsharded(params, "f32", toks, steps=f32_steps))
    # how far rounding alone moves the unsharded model: its bf16 logits from its f32 ones
    bf16_vs_f32 = float((base[:, :f32_steps + 1, :v].float() - base32[..., :v]).abs().max())

    # ---- tensor-parallel f32 under both rule sets: the correctness check ----
    placed = _place_consuming(params, params_shardings(params, mesh, fsdp_axis=None))
    del params
    for layout, rules in layouts:
        (got32, _, _, _, _, cache32), routes32 = recorded(
            lambda: sharded(placed, "f32", rules, layout, toks, steps=f32_steps))
        err32, held32, flips32 = compare(got32, base32, routes32, base32_routes)
        logit_err = held_max(err32, held32)
        cache32_err = max(float((a.full() - b).abs().max() / b.abs().max().clamp(min=1e-30))
                          for a, b in zip(tree_leaves(cache32), tree_leaves(base32_cache)))
        emit({"phase": "tensor_parallel", "run": f"{name}/{layout}/f32", "card": card,
              "mesh": mesh.shape, "layers": layers, "layer_counts": counts, "layout": layout,
              "cache_impl": rules.cache_impl, "dtype": "float32", "steps": f32_steps,
              "logit_tol": F32_LOGIT_TOL,
              "prefill_vs_unsharded": held_max(err32[:, :1], held32[:, :1]),
              "decode_vs_unsharded": held_max(err32[:, 1:], held32[:, 1:]),
              "cache_vs_unsharded_relative": cache32_err,
              "held_positions": int(held32.sum()), "compared_positions": int(held32.numel()),
              "route_mismatches_by_layer": flips32, "route_mismatches_allowed": F32_ROUTE_FLIPS,
              "logit_max_abs": float(base32[..., :v].abs().max()),
              "unsharded_bf16_vs_f32": bf16_vs_f32})
        del got32, cache32, routes32
        free()
        check(sum(flips32 or [0]) <= F32_ROUTE_FLIPS,
              f"tensor_parallel {name}/{layout}/f32: routes apart from the unsharded f32 run at "
              f"{flips32} (layer, token) pairs, more than {F32_ROUTE_FLIPS}")
        check(logit_err is not None and logit_err <= F32_LOGIT_TOL,
              f"tensor_parallel {name}/{layout}/f32: logits vs unsharded f32 {logit_err} > "
              f"{F32_LOGIT_TOL}")
        check(cache32_err <= F32_LOGIT_TOL,
              f"tensor_parallel {name}/{layout}/f32: cache vs unsharded f32 {cache32_err} "
              f"(relative) > {F32_LOGIT_TOL}")
    del placed, base32, base32_cache, base32_routes
    free()

    # ---- tensor-parallel bf16 under both rule sets ----
    top2 = base[..., :v].float().topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]  # the unsharded top-2 margin at each position
    params = init()  # the same bf16 weights again
    placed = _place_consuming(params, params_shardings(params, mesh, fsdp_axis=None))
    del params
    free()
    rank_bytes = [sum(t.shards[r].numel() * t.shards[r].element_size()
                      for t in tree_leaves(placed)) for r in range(mesh.size)]
    want_bytes = _tp_rank_param_bytes(cfg, n)
    totals: dict = {}
    for layout, rules in layouts:
        sharded(placed, "bf16", rules, layout, toks, steps=1)  # warm-up: threads, handles
        reset_launches()
        (got, _, prefill_ms, rise, decode_ms, cache), routes = recorded(
            lambda: sharded(placed, "bf16", rules, layout, toks))
        torch.cuda.synchronize()
        launches = read_launches()
        for k, c in launches.items():
            totals[k] = totals.get(k, 0) + c
        err, held, route_mismatches = compare(got, base, routes, base_routes)
        gf, bf = got[..., :v].float(), base[..., :v].float()
        prefill_err, decode_err = held_max(err[:, :1], held[:, :1]), held_max(err[:, 1:],
                                                                             held[:, 1:])
        picked, unsharded_pick = gf.argmax(-1), bf.argmax(-1)
        clear = (margin > TP_BF16_TOL) & held
        disagree = int(((picked != unsharded_pick) & clear).sum())
        cache_err = max(float((a.full().float() - b.float()).abs().max())
                        for a, b in zip(tree_leaves(cache), tree_leaves(base_cache)))
        emit({"phase": "tensor_parallel", "run": f"{name}/{layout}", "card": card,
              "mesh": mesh.shape, "layers": layers, "layer_counts": counts, "layout": layout,
              "cache_impl": rules.cache_impl, "batch": SERVE_BATCH, "prompt": SERVE_PROMPT,
              "steps": steps, "kv_heads_split": bool(cfg.num_kv_heads)
              and cfg.num_kv_heads % n == 0,
              "prefill_ms": prefill_ms, "unsharded_prefill_ms": base_prefill_ms,
              "decode_ms_per_step": decode_ms, "unsharded_decode_ms_per_step": base_decode_ms,
              "prefill_peak_rise_gb": rise / 1e9,
              "unsharded_prefill_peak_rise_gb": base_rise / 1e9,
              "rank_param_bytes": rank_bytes[0], "rank_param_bytes_closed_form": want_bytes,
              "unsharded_param_bytes": whole_bytes,
              "rank_share_of_unsharded": rank_bytes[0] / whole_bytes,
              "launches": launches, "launches_expected": expected,
              "unsharded_launches": base_launches,
              "logit_tol": TP_BF16_TOL if dense_only else None,
              "unsharded_bf16_vs_f32": bf16_vs_f32,
              "prefill_vs_unsharded": prefill_err, "decode_vs_unsharded": decode_err,
              "cache_vs_unsharded": cache_err,
              "held_positions": int(held.sum()), "compared_positions": int(held.numel()),
              "route_mismatches_by_layer": route_mismatches,
              "greedy_positions": int(picked.numel()),
              "greedy_positions_past_margin": int(clear.sum()),
              "greedy_disagreements": int((picked != unsharded_pick).sum()),
              "greedy_disagreements_past_margin": disagree,
              "logit_max_abs": float(bf.abs().max()),
              "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
        check(bool(torch.isfinite(gf).all()), f"tensor_parallel {name}/{layout}: finite logits")
        if dense_only:  # else printed only: the f32 runs above decide
            check(prefill_err <= TP_BF16_TOL and decode_err <= TP_BF16_TOL,
                  f"tensor_parallel {name}/{layout}: logits vs unsharded {prefill_err}, "
                  f"{decode_err} > {TP_BF16_TOL}")
            check(cache_err <= TP_BF16_TOL, f"tensor_parallel {name}/{layout}: cache vs "
                  f"unsharded {cache_err} > {TP_BF16_TOL}")
            check(disagree == 0, f"tensor_parallel {name}/{layout}: {disagree} greedy tokens "
                  f"differ where the unsharded top-2 margin exceeds {TP_BF16_TOL}")
        for k, want in expected.items():
            check(launches[k] == want and base_launches[k] == want // mesh.size,
                  f"tensor_parallel {name}/{layout}: {k} launches {launches[k]} (unsharded "
                  f"{base_launches[k]}) != {mesh.size} ranks x {want // mesh.size} layers "
                  f"in one prefill")
        check(all(b == want_bytes for b in rank_bytes),
              f"tensor_parallel {name}/{layout}: rank param bytes {sorted(set(rank_bytes))} "
              f"!= {want_bytes}")
        del got, cache, routes
        free()
    del placed, base, base_cache, base_routes
    free()
    return totals


# ---------------------------------------------------------------------------
# long_decode: a batch of one at long context under long_decode_rules
# ---------------------------------------------------------------------------

#: the long-context serving path (``long_decode_rules``: the cache's rows over
#: ``data``, the heads over ``model``) at full width on a (2, 4) (data, model)
#: mesh, a batch of one and a cache of ``LD_MAX_LEN`` rows, the ``long_500k``
#: cell's ``seq_len``: arch -> (layers, prompt).  mamba2-1.3b at 8 of 48
#: layers (cut for the script's time limit: each decode step's host work
#: grows with ranks × layers);
#: mixtral-8x7b at 2 of 32 layers, its prompt twice its 4096-slot ring, which
#: the prompt wraps; jamba-v0.1-52b's first period (8 of 32 layers: 7 mamba2,
#: 1 attention, 4 MoE), whose f32 weights (53 GB) leave room for its f32
#: caches (4.3 GB a copy) and little more
LD_RUNS = {"mamba2-1.3b": (8, 4096), "mixtral-8x7b": (2, 8192), "jamba-v0.1-52b": (8, 4096)}
LD_MESH = (2, 4)
LD_MAX_LEN = 524_288
LD_BF16_STEPS, LD_F32_STEPS = 8, 4
#: the flash kernel at the long prefill's rank shapes: label -> (H, Hkv,
#: window, memory, B, L) of q (B, L, H, 128) and k/v (B, L, Hkv, 128): a
#: rank's 8 of 32 q heads and its 2 of 8 kv heads (``wk``/``wv`` split 2 a
#: rank), causal over the whole prompt (mixtral's with its window)
LD_FLASH_SHAPES = {"mixtral_long_rank_of_2x4": (8, 2, 4096, 0, 1, 8192),
                   "jamba_long_rank_of_2x4": (8, 2, 0, 0, 1, 4096)}
#: the SSD kernel at the long prefill's rank shapes: label -> (heads, state,
#: B, L) of x (B, L, heads, 64): mamba2-1.3b's 64 heads and jamba's 128 over 4
LD_SSD_SHAPES = {"mamba2_long_rank_of_2x4": (16, 128, 1, 4096),
                 "jamba_long_rank_of_2x4": (32, 16, 1, 4096)}


def _map_named(fn, tree, *rest, name=None):
    """``fn(name, leaf, *leaves)`` over the leaves of a cache tree (dicts and
    tuples) and of trees like it, ``name`` the key that holds the leaf; the
    tree of the results."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, tree[k], *(r[k] for r in rest), name=k) for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_named(fn, t, *(r[i] for r in rest), name=name)
                          for i, t in enumerate(tree))
    return fn(name, tree, *rest)


def _long_cache(model, mesh, dtype: torch.dtype, dev: torch.device):
    """A zeroed cache of ``LD_MAX_LEN`` rows for a batch of one, placed by
    ``cache_shardings(long_context=True)`` block by block (no whole copy).
    A ``k``/``v`` block lies on every model rank of its data rank (each
    holds every kv head of its rows), and those ranks write the same values
    into it: on one card they share one tensor, as each card of a real mesh
    holds one.  Every other leaf is a copy a rank."""
    from repro_torch.distributed import ShardedTensor, cache_shardings

    meta = model.init_cache(1, LD_MAX_LEN, dtype=dtype, device="meta")

    def place(name, leaf, sh):
        blocks, shards = {}, []
        for r in range(mesh.size):
            index = tuple((i.start, i.stop) for i in sh.index(r, leaf.shape))
            if name not in ("k", "v") or index not in blocks:
                blocks[index] = torch.zeros(sh.shard_shape(leaf.shape), dtype=leaf.dtype,
                                            device=dev)
            shards.append(blocks[index])
        return ShardedTensor(leaf.shape, sh, shards)

    return _map_named(place, meta, cache_shardings(meta, mesh, long_context=True))


def _max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| in f32, 65,536 slices of dim -3 at a time (a cache
    block of 262,144 rows would need gigabytes of temporaries whole)."""
    if a.ndim < 3:
        return float((a.float() - b.float()).abs().max())
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a.split(65_536, -3), b.split(65_536, -3)))


def _cache_err(sharded, whole, *, relative: bool = True, skip=(), states: bool = True
               ) -> float:
    """The largest difference between every rank's block of each
    ``sharded`` cache leaf and the same slice of ``whole`` (over the leaf's
    largest magnitude where ``relative``).  A ``k``/``v`` leaf of ``whole``
    may hold only the first rows (:func:`_written`): the block's rows past
    them must be 0; its rows in a ``skip`` range ``(lo, hi)`` are not
    compared, nor, without ``states``, any other leaf (the SSM state)."""
    worst = 0.0

    def one(name, st, w):
        nonlocal worst
        if name not in ("k", "v") and not states:
            return
        scale = float(w.abs().max().clamp(min=1e-30)) if relative else 1.0
        for r in st.sharding.owners():
            index, block = st.sharding.index(r, st.shape), st.shards[r]
            if name not in ("k", "v"):
                worst = max(worst, _max_abs_diff(block, w[index]) / scale)
                continue
            lo, n = index[-3].start, block.shape[-3]
            cuts = sorted({lo, lo + n, *(min(max(x, lo), lo + n)
                                         for x in (*sum(skip, ()), w.shape[-3]))})
            for a, b in zip(cuts, cuts[1:]):
                if any(s0 <= a < s1 for s0, s1 in skip):
                    continue
                mine = block[..., a - lo:b - lo, :, :]
                want = (w[(*index[:-3], slice(a, b))] if a < w.shape[-3] else
                        torch.zeros_like(mine[..., :1, :, :]).expand_as(mine))
                worst = max(worst, _max_abs_diff(mine, want) / scale)

    _map_named(one, sharded, whole)
    return worst


def _recording_margins(fn):
    """``fn()`` with the MoE router's margin recorded: (its result, one
    ``(tokens,)`` f32 tensor a router call of the k-th minus the (k+1)-th
    router logit, computed as ``repro_torch.models.moe._route`` computes
    the logits)."""
    import repro_torch.models.moe as moe

    real, margins = moe._route, []

    def route(p, cfg, xt):
        logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)
        top = logits.topk(cfg.moe_top_k + 1, -1).values
        margins.append((top[..., -2] - top[..., -1]).reshape(-1))
        return real(p, cfg, xt)

    moe._route = route
    try:
        return fn(), margins
    finally:
        moe._route = real


def _seed_rows(cache, start: int, seed: int, dev: torch.device) -> None:
    """Seeded draws (N(0, 1/4)) into rows ``[start, S)`` of every ``k``/``v``
    leaf of ``cache`` (the rows no run wrote; all of a ring where ``start``
    is 0), drawn on the card 65,536 rows at a time, so that an unsharded
    cache and a placed one (every distinct block of a ``ShardedTensor``
    leaf) get the same values from the same ``seed``."""
    from repro_torch.distributed import ShardedTensor

    gen = torch.Generator(device=dev).manual_seed(seed)

    def one(name, leaf):
        if name not in ("k", "v"):
            return
        blocks = ([(0, leaf)] if not isinstance(leaf, ShardedTensor) else list(
            {id(t): (leaf.sharding.index(r, leaf.shape)[-3].start, t)
             for r, t in enumerate(leaf.shards)}.values()))
        rows, shape = leaf.shape[-3], tuple(leaf.shape)
        for r0 in range(start, rows, 65_536):
            r1 = min(r0 + 65_536, rows)
            draw = torch.randn((*shape[:-3], r1 - r0, *shape[-2:]), generator=gen,
                               device=dev).mul_(0.5)
            for lo, t in blocks:
                a, b = max(r0, lo), min(r1, lo + t.shape[-3])
                if a < b:
                    t[..., a - lo:b - lo, :, :] = draw[..., a - r0:b - r0, :, :].to(t.dtype)

    _map_named(one, cache)


def _written(cache, rows: int):
    """A copy of ``cache`` with its ``k``/``v`` leaves cut to their first
    ``rows`` rows: what a prompt and steps of ``rows`` tokens wrote."""
    return _map_named(lambda name, leaf: (leaf[..., :rows, :, :] if name in ("k", "v")
                                          else leaf).clone(), cache)


def _long_cache_bytes(cfg, dtype: torch.dtype) -> int:
    """Closed form of one rank's cache bytes on the (2, 4) mesh: each
    attention layer's k and v for half the rows (of the ring where the
    window is shorter) and every kv head; each mamba2 layer's conv
    (``(W-1, din + 2N)``) and f32 ``h`` (``(NH, P, N)``) a quarter of their
    channels and heads, the model axis dividing both."""
    counts = layer_counts(cfg)
    size = torch.tensor([], dtype=dtype).element_size()
    ring = min(LD_MAX_LEN, cfg.sliding_window) if cfg.sliding_window else LD_MAX_LEN
    kv = counts.get("attn", 0) * 2 * (ring // LD_MESH[0]) * cfg.num_kv_heads * \
        cfg.resolved_head_dim * size
    din, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    ssm = counts.get("mamba2", 0) * (
        (cfg.ssm_conv_width - 1) * (din + 2 * n) // LD_MESH[1] * size
        + din // cfg.ssm_head_dim // LD_MESH[1] * cfg.ssm_head_dim * n * 4) if n else 0
    return kv + ssm


def long_decode_phase(seed: int, dev: torch.device, card: str) -> dict:
    """The serving path at long context (``sharded_prefill`` /
    ``sharded_decode_step`` under ``long_decode_rules``), every rank a
    position on ``dev``, against the unsharded model: every config of
    ``LD_RUNS``; returns the kernels' launches of the bf16 runs."""
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    totals = {k: 0 for k in read_launches()}
    seconds = {}
    for arch, (layers, prompt) in LD_RUNS.items():
        t0 = time.perf_counter()
        for k, c in _long_decode_rows(arch, layers, prompt, seed, dev, card).items():
            totals[k] += c
        seconds[arch] = time.perf_counter() - t0
    emit({"phase": "long_decode", "run": "launches", "card": card, "launches": totals,
          "seconds": time.perf_counter() - t_phase, "seconds_by_run": seconds})
    check(totals["flash_attention"] > 0 and totals["ssd_scan"] > 0,
          f"long_decode: flash_attention and ssd_scan launched ({totals})")
    return totals


def _long_decode_rows(arch: str, layers: int, prompt: int, seed: int, dev: torch.device,
                      card: str) -> dict:
    """One config of ``LD_RUNS`` (``long_decode_phase``).  The unsharded
    model runs in bf16 (a prompt and ``LD_BF16_STEPS`` greedy steps), then
    on the same weights upcast to f32 (the prompt, ``LD_F32_STEPS`` steps
    fed the bf16 run's tokens, then one step at the last slot over seeded
    rows); the long-context f32 run does the same and is held to it
    (logits, every rank's cache block, the MoE routes); the long-context
    bf16 run is printed beside the unsharded one.  Emits a row per run and
    returns the kernels' launches of the bf16 run."""
    import dataclasses

    import numpy as np

    from repro_torch._pytree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.distributed import (
        long_decode_rules,
        params_shardings,
        sharded_decode_step,
        sharded_prefill,
    )
    from repro_torch.distributed.spmd import collective_census
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), num_layers=layers, attn_impl="flash")
    counts = layer_counts(cfg)
    moe_layers = counts.get("moe", 0)
    models = {"bf16": build_model(cfg),
              "f32": build_model(dataclasses.replace(cfg, dtype="float32"))}
    cache_dtype = {"bf16": torch.bfloat16, "f32": torch.float32}
    prompts = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, prompt), dtype=np.int64), device=dev)
    v = cfg.vocab_size
    mesh = compat_make_mesh(LD_MESH, ("data", "model"), devices=(dev,))
    rules = long_decode_rules(mesh)
    expected = {"flash_attention": mesh.size * counts.get("attn", 0),
                "ssd_scan": mesh.size * counts.get("mamba2", 0)}
    last = LD_MAX_LEN - 1  # the dry-run's decode slot
    ring = bool(cfg.sliding_window) and cfg.sliding_window < LD_MAX_LEN
    runs_rows = prompt + LD_F32_STEPS  # the tokens the f32 runs wrote
    seed_from = 0 if ring else runs_rows  # a ring's slots would hold tokens no run wrote

    def recorded(fn):  # fn()'s result and the MoE routes it recorded (None: no MoE)
        return _recording_routes(fn) if moe_layers else (fn(), None)

    def unsharded(params, kind, toks, steps):
        model = models[kind]
        cache = model.init_cache(1, LD_MAX_LEN, dtype=cache_dtype[kind], device=dev)
        with torch.no_grad():
            return _greedy_run(lambda: model.prefill(params, {"tokens": prompts}, cache)[0],
                               lambda tok, pos: model.decode_step(params, cache, tok, pos)[0],
                               toks, steps, start=prompt) + (cache,)

    def sharded(placed, kind, toks, steps):
        model, cache = models[kind], _long_cache(models[kind], mesh, cache_dtype[kind], dev)
        with torch.no_grad():
            return _greedy_run(
                lambda: sharded_prefill(model, placed, {"tokens": prompts}, cache, mesh=mesh,
                                        rules=rules)[0],
                lambda tok, pos: sharded_decode_step(model, placed, cache, tok, pos, mesh=mesh,
                                                     rules=rules)[0],
                toks, steps, start=prompt) + (cache,)

    def held(got_routes, base_routes, n: int, first: int):
        """(1, n) logits whose positions ``first + i`` route alike in every
        MoE layer, and the flips a layer (None: no MoE)."""
        if not moe_layers:
            return torch.ones((1, n), dtype=torch.bool, device=dev), None
        f = _route_flips(_per_layer(base_routes, moe_layers), _per_layer(got_routes, moe_layers))
        return ~f[:, :, first + torch.arange(n, device=dev)].any(0), [int(x.sum()) for x in f]

    def held_max(err, ok):
        return float(err[ok].max()) if ok.any() else None

    def route_flips(got_routes, base_routes, margins) -> list:
        """[(position, layer, the unsharded run's router margin there)] of
        every route flip, in position order."""
        if not moe_layers:
            return []
        f = _route_flips(_per_layer(base_routes, moe_layers), _per_layer(got_routes, moe_layers))
        m = [torch.cat(margins[i::moe_layers]) for i in range(moe_layers)]
        return sorted((p, layer, float(m[layer][p])) for layer, _, p in f.nonzero().tolist())

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def init():
        return models["bf16"].init(torch.Generator(device=dev).manual_seed(seed), device=dev)

    # ---- the unsharded model: bf16, then f32 on the same weights upcast ----
    params = init()
    whole_param_bytes = _tree_bytes(params)
    unsharded(params, "bf16", None, 1)  # warm-up
    free()
    reset_launches()
    (base, toks, base_prefill_ms, base_rise, base_decode_ms, base_cache), base_routes = \
        recorded(lambda: unsharded(params, "bf16", None, LD_BF16_STEPS))
    torch.cuda.synchronize()
    base_launches = read_launches()
    upcast_in_place(params)
    free()
    ((base32, _, _, _, _, base32_cache), base32_routes), margins32 = _recording_margins(
        lambda: recorded(lambda: unsharded(params, "f32", toks, LD_F32_STEPS)))
    bf16_vs_f32 = float((base[:, :LD_F32_STEPS + 1, :v].float() - base32[..., :v]).abs().max())
    snap32 = _written(base32_cache, runs_rows)
    _seed_rows(base32_cache, seed_from, seed + 1, dev)
    last_tok = toks[:, LD_F32_STEPS:LD_F32_STEPS + 1]
    with torch.no_grad():
        ((want_last, _), want_last_routes), margins_last = _recording_margins(lambda: recorded(
            lambda: models["f32"].decode_step(params, base32_cache, last_tok, last)))

    # ---- long-context f32 on the same weights: the check that decides ----
    placed = _place_consuming(params, params_shardings(params, mesh, fsdp_axis=None))
    del params
    free()
    (got32, _, _, _, _, cache32), routes32 = recorded(
        lambda: sharded(placed, "f32", toks, LD_F32_STEPS))
    err32 = (got32[..., :v] - base32[..., :v]).abs().amax(-1)  # (1, 1 + steps)
    held32, flips32 = held(routes32, base32_routes, err32.shape[1], prompt - 1)
    flipped = route_flips(routes32, base32_routes, margins32)
    # a flip moves every later position (the SSM state, the attention rows):
    # the rows from the first flipped token on are not held, nor the state
    skip = [(0, LD_MAX_LEN) if ring else (flipped[0][0], runs_rows)] if flipped else []
    written_err = _cache_err(cache32, snap32, skip=skip, states=not flipped)
    _seed_rows(cache32, seed_from, seed + 1, dev)
    with torch.no_grad():
        (got_last, _), got_last_routes = recorded(lambda: sharded_decode_step(
            models["f32"], placed, cache32, last_tok, last, mesh=mesh, rules=rules))
    held_last, flips_last = held(got_last_routes, want_last_routes, 1, 0)
    flipped_last = route_flips(got_last_routes, want_last_routes, margins_last)
    last_err = held_max((got_last[..., :v] - want_last[..., :v]).abs().amax(-1).reshape(1, 1),
                        held_last)
    slot = last % LD_MAX_LEN if not ring else last % cfg.sliding_window
    last_cache_err = _cache_err(cache32, base32_cache,
                                skip=skip + ([(slot, slot + 1)] if flipped_last else []),
                                states=not (flipped or flipped_last))
    near_ties = [f for f in flipped + flipped_last if f[2] < ROUTE_NEAR_TIE]
    logit_err = held_max(err32, held32)
    row = {"phase": "long_decode", "run": f"{arch}/f32", "card": card, "mesh": mesh.shape,
           "layers": layers, "layer_counts": counts, "rules": "long_decode_rules",
           "batch": 1, "prompt": prompt, "cache_rows": LD_MAX_LEN, "dtype": "float32",
           "steps": LD_F32_STEPS, "logit_tol": F32_LOGIT_TOL,
           "prefill_vs_unsharded": held_max(err32[:, :1], held32[:, :1]),
           "decode_vs_unsharded": held_max(err32[:, 1:], held32[:, 1:]),
           "cache_vs_unsharded_relative": written_err,
           "last_slot": last, "last_slot_seeded_from": seed_from,
           "last_slot_vs_unsharded": last_err,
           "last_slot_cache_vs_unsharded_relative": last_cache_err,
           "cache_rows_not_held": skip, "state_held": not (flipped or flipped_last),
           "route_mismatches_by_layer": flips32,
           "last_slot_route_mismatches_by_layer": flips_last,
           "route_flips_position_layer_margin": flipped + [(last, l, m) for _, l, m in
                                                           flipped_last],
           "route_near_tie": ROUTE_NEAR_TIE, "route_near_ties": len(near_ties),
           "route_near_ties_allowed": F32_ROUTE_FLIPS,
           "held_positions": int(held32.sum()) + int(held_last.sum()),
           "compared_positions": held32.numel() + 1,
           "logit_max_abs": float(base32[..., :v].abs().max()),
           "unsharded_bf16_vs_f32": bf16_vs_f32}
    emit(row)
    del got32, cache32, routes32, base32, base32_cache, base32_routes, snap32, placed
    free()
    name = f"long_decode {arch}/f32"
    check(len(near_ties) <= F32_ROUTE_FLIPS,
          f"{name}: routes apart from the unsharded f32 run at {len(near_ties)} near-ties, "
          f"more than {F32_ROUTE_FLIPS}")
    for what, flips in (("greedy", flipped), ("last-slot", flipped_last)):
        check(not flips or flips[0][2] < ROUTE_NEAR_TIE,
              f"{name}: the {what} run's first route flip {flips[:1]} is at a router margin "
              f"past {ROUTE_NEAR_TIE}: no near-tie")
    for key in ("prefill_vs_unsharded", "decode_vs_unsharded", "cache_vs_unsharded_relative",
                "last_slot_vs_unsharded", "last_slot_cache_vs_unsharded_relative"):
        check(row[key] is not None and row[key] <= F32_LOGIT_TOL,
              f"{name}: {key} {row[key]} > {F32_LOGIT_TOL}")

    # ---- long-context bf16 on the same bf16 weights: printed ----
    params = init()
    placed = _place_consuming(params, params_shardings(params, mesh, fsdp_axis=None))
    del params
    free()
    rank_param_bytes = sum(t.shards[0].numel() * t.shards[0].element_size()
                           for t in tree_leaves(placed))
    want_param_bytes = _tp_rank_param_bytes(cfg, LD_MESH[1])
    sharded(placed, "bf16", toks, 1)  # warm-up: threads, handles
    free()
    reset_launches()
    (got, _, prefill_ms, rise, decode_ms, cache), routes = recorded(
        lambda: sharded(placed, "bf16", toks, LD_BF16_STEPS))
    torch.cuda.synchronize()
    launches = read_launches()
    err = (got[..., :v].float() - base[..., :v].float()).abs().amax(-1)
    ok, flips_bf16 = held(routes, base_routes, err.shape[1], prompt - 1)
    cache_err = _cache_err(cache, base_cache, relative=False)
    rank_cache_bytes = sum(t.shards[0].numel() * t.shards[0].element_size()
                           for t in tree_leaves(cache))
    want_cache_bytes = _long_cache_bytes(cfg, torch.bfloat16)
    with collective_census() as census, torch.no_grad():
        step_ms, _ = _wall_ms(lambda: sharded_decode_step(
            models["bf16"], placed, cache, toks[:, -1:], prompt + LD_BF16_STEPS, mesh=mesh,
            rules=rules))
    emit({"phase": "long_decode", "run": arch, "card": card, "mesh": mesh.shape,
          "layers": layers, "layer_counts": counts, "rules": "long_decode_rules",
          "batch": 1, "prompt": prompt, "cache_rows": LD_MAX_LEN, "steps": LD_BF16_STEPS,
          "prefill_ms": prefill_ms, "unsharded_prefill_ms": base_prefill_ms,
          "decode_ms_per_step": decode_ms, "unsharded_decode_ms_per_step": base_decode_ms,
          "prefill_peak_rise_gb": rise / 1e9, "unsharded_prefill_peak_rise_gb": base_rise / 1e9,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
          "rank_cache_bytes": rank_cache_bytes, "rank_cache_bytes_closed_form": want_cache_bytes,
          "unsharded_cache_bytes": _tree_bytes(base_cache),
          "rank_param_bytes": rank_param_bytes, "rank_param_bytes_closed_form": want_param_bytes,
          "unsharded_param_bytes": whole_param_bytes,
          "launches": launches, "launches_expected": expected,
          "unsharded_launches": base_launches,
          "logit_tol": None, "unsharded_bf16_vs_f32": bf16_vs_f32,
          "prefill_vs_unsharded": held_max(err[:, :1], ok[:, :1]),
          "decode_vs_unsharded": held_max(err[:, 1:], ok[:, 1:]),
          "cache_vs_unsharded": cache_err, "route_mismatches_by_layer": flips_bf16,
          "held_positions": int(ok.sum()), "compared_positions": int(ok.numel()),
          "greedy_disagreements": int((got[..., :v].argmax(-1) != base[..., :v].argmax(-1))
                                      .sum()),
          "logit_max_abs": float(base[..., :v].float().abs().max()),
          "census_decode_step": census, "census_step_ms": step_ms})
    check(bool(torch.isfinite(got[..., :v].float()).all()),
          f"long_decode {arch}: finite logits")
    for k, want in expected.items():
        check(launches[k] == want and base_launches[k] == want // mesh.size,
              f"long_decode {arch}: {k} launches {launches[k]} (unsharded {base_launches[k]}) "
              f"!= {mesh.size} ranks x {want // mesh.size} layers in one prefill")
    check(rank_cache_bytes == want_cache_bytes,
          f"long_decode {arch}: rank cache bytes {rank_cache_bytes} != {want_cache_bytes}")
    check(rank_param_bytes == want_param_bytes,
          f"long_decode {arch}: rank param bytes {rank_param_bytes} != {want_param_bytes}")
    del got, cache, routes, placed, base, base_cache, base_routes
    free()
    return launches


# ---------------------------------------------------------------------------
# tp_train: the train step tensor-parallel over model under train_rules(_sp)
# ---------------------------------------------------------------------------

#: lm100m's steps and meshes; qwen3-32b at full width: its layers, blocks,
#: rows a block and tokens a row; the learning rate (AdamW's defaults
#: otherwise, clip_norm 1.0)
TP_TRAIN_STEPS, TP_TRAIN_LR = 2, 1e-3
#: lm100m's blocks of 8 × 1024 a step (4, the train phase's, until the SSM,
#: hybrid and MoE rows came: the script's time)
TP_TRAIN_LM_BLOCKS = 2
TP_TRAIN_MESHES = (((2, 2, 2), ("pod", "data", "model")), ((1, 4), ("data", "model")))
TP_TRAIN_QWEN3 = {"layers": 1, "blocks": 2, "rows": 2, "seq": 512}
#: f32 against the unsharded step: the loss relative, each gradient and
#: moment leaf against its largest magnitude; a param within 2·lr (AdamW
#: moves an element by at most about lr a step)
TP_TRAIN_LOSS_RTOL, TP_TRAIN_TREE_TOL = 1e-5, 1e-3
#: the phase's own limit: a deadlock in a backward fails the run here
TP_TRAIN_TIMEOUT_S = 600.0


def _guarded(fn, seconds: float, what: str):
    """``fn()`` in a thread joined within ``seconds``; past them the
    script exits non-zero at once (a rank thread that hangs in a rendezvous
    cannot be woken)."""
    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as err:  # handed to the caller
            box["error"] = err

    t = threading.Thread(target=run, name=what, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        print(f"chip_smoke: {what} did not finish within {seconds:.0f} s", file=sys.stderr,
              flush=True)
        os._exit(1)
    if "error" in box:
        raise box["error"]
    return box["value"]


def _backward_threads(dev: torch.device) -> dict:
    """A two-rank ``pvary``/``psum`` backward on ``dev``, both ranks on it:
    through the collectives' autograd nodes (``torch.autograd.grad`` in the
    rank thread), and through ``value_and_grad``'s backward in segments.
    Returns which threads ran the node's backward and what it raised, and
    whether the segmented gradients equal the closed form."""
    from repro_torch.distributed import P, psum, pvary, shard_map
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.optim.grad_accum import value_and_grad

    mesh = compat_make_mesh((1, 2), ("data", "model"), devices=(dev,))
    v = torch.arange(6.0, device=dev).reshape(1, 6)
    w = torch.arange(12.0, device=dev).reshape(2, 6)
    threads, errors = [], []

    def loss(p, b):
        return psum((pvary(p, "model") * b["w"]).sum(), "model")

    def node(vl, wl):
        x = vl.detach().requires_grad_()
        y = pvary(x, "model")
        y.register_hook(lambda g: threads.append(threading.current_thread().name))
        try:
            torch.autograd.grad(psum((y * wl).sum(), "model"), x)
        except RuntimeError as err:
            errors.append(str(err))
        return vl

    def segments(vl, wl):
        return value_and_grad(loss, vl, {"w": wl})[1]

    shard_map(node, mesh=mesh, in_specs=(P("data"), P("model")), out_specs=P("data"))(v, w)
    grads = shard_map(segments, mesh=mesh, in_specs=(P("data"), P("model")),
                      out_specs=P("model"))(v, w)
    return {"node_backward_threads": threads, "rank_threads": "shard_map-rank",
            "node_backward_in_a_rank_thread": any(t == "shard_map-rank" for t in threads),
            "node_errors": [e.split(":")[0] for e in errors],
            "segments_exact": bool(torch.equal(grads, (w[0] + w[1]).expand(2, 6)))}


def _leaf_gaps(got, want) -> float:
    """The largest over leaves of a tree's difference (ShardedTensor or
    plain leaves) from a whole tree (on the card or kept on the host, a leaf
    at a time on the card), over the whole leaf's largest magnitude."""
    from repro_torch._pytree import tree_leaves

    worst = 0.0
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        if not w.numel():  # a segment of no repeats (deepseek-v2 cut to one layer)
            continue
        full = g.full() if hasattr(g, "full") else g
        w = w.to(full.device)
        scale = float(w.abs().max())
        gap = float((full - w).abs().max())
        worst = max(worst, gap / scale if scale else gap)
    return worst


def _rank_bytes(tree, rank: int = 0) -> int:
    from repro_torch._pytree import tree_leaves

    return sum(t.shards[rank].numel() * t.shards[rank].element_size() for t in tree_leaves(tree))


def _tp_train_rows(name: str, cfg, mesh_shape: tuple, axes: tuple, blocks: list, seed: int,
                   dev: torch.device, card: str, *, hold_update: bool) -> dict:
    """``cfg`` trained ``len(blocks)`` steps from one seeded init by
    ``sharded_train_step(..., rules=train_rules(mesh))`` with every rank on
    ``dev``, beside the unsharded step (``accumulate_gradients``): each
    step's tensor-parallel loss and gradients (``tensor_parallel_gradients``)
    held to the unsharded step's; with ``hold_update`` the unsharded
    ``adamw_update`` runs too, the moments and params after the last step
    are held to its, and a data-parallel step from the same params is
    timed; without, the unsharded params are freed before the
    tensor-parallel step.  Emits one line."""
    from repro_torch._pytree import tree_leaves
    from repro_torch.distributed import (
        device_put,
        params_shardings,
        sharded_train_step,
        tensor_parallel_gradients,
        train_rules,
    )
    from repro_torch.distributed.spmd import collective_census
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import accumulate_gradients, adamw_init, adamw_update

    model = build_model(cfg)
    mesh = compat_make_mesh(mesh_shape, axes, devices=(dev,))
    rules = train_rules(mesh)
    params = _with_gates(model.init(torch.Generator(device=dev).manual_seed(seed), device=dev,
                                    master=True))
    n_params = sum(t.numel() for t in tree_leaves(params))
    shardings = params_shardings(params, mesh, fsdp_axis="data")
    placed = device_put(params, shardings)
    opt_ref = adamw_init(params) if hold_update else None
    opt = adamw_init(params)  # zeros; the step places them as the params lie
    row = {"phase": "tp_train", "run": name, "card": card, "mesh": mesh.shape,
           "params": n_params, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "tokens_per_step": int(blocks[0]["tokens"].numel()), "steps": len(blocks)}
    losses, ref_losses, grad_gaps, loss_gaps, ms, ref_ms = [], [], [], [], [], []
    accumulate_gradients(model.loss, params, blocks[0])  # warm: the times compare warm calls
    for s, blk in enumerate(blocks):
        t_ref, (loss_ref, g_ref) = _wall_ms(lambda: accumulate_gradients(model.loss, params, blk))
        loss_g, g_tp = tensor_parallel_gradients(model.loss, placed, blk, mesh=mesh, rules=rules)
        grad_gaps.append(_leaf_gaps(g_tp, g_ref))
        loss_gaps.append(abs(float(loss_g) - float(loss_ref)) / abs(float(loss_ref)))
        if s == 0:  # the encoder's and the cross layers' gradients, which a gate of 0 zeroes
            row["memory_path_leaves"] = len(_memory_path_leaves(g_tp))
            row["memory_path_zero_leaves"] = [n for n, g in _memory_path_leaves(g_tp)
                                              if not bool((g.full() != 0).any())]
        del g_tp
        if hold_update:
            params, opt_ref = adamw_update(params, g_ref, opt_ref, lr=TP_TRAIN_LR)
        else:
            params = None  # the unsharded step's memory, freed before the sharded step's
        del g_ref
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with collective_census() as census:
            t_tp, (placed, opt, loss) = _wall_ms(lambda: sharded_train_step(
                model.loss, placed, opt, blk, mesh=mesh, lr=TP_TRAIN_LR, rules=rules))
        peak = torch.cuda.max_memory_allocated(dev) - before
        losses.append(float(loss))
        ref_losses.append(float(loss_ref))
        loss_gaps.append(abs(float(loss) - float(loss_ref)) / abs(float(loss_ref)))
        ms.append(t_tp)
        ref_ms.append(t_ref)
        if s == 0:
            row["census_step"] = census
            row["peak_memory_rise_gb"] = peak / 1e9
    row.update(losses=losses, unsharded_losses=ref_losses, loss_gap_rel=max(loss_gaps),
               loss_gap_rel_by_step=loss_gaps,
               grad_gap=max(grad_gaps), grad_gap_by_step=grad_gaps, step_ms=ms,
               unsharded_gradients_ms=ref_ms,
               step_vs_unsharded_gradients=statistics.median(ms) / statistics.median(ref_ms),
               rank_param_bytes=_rank_bytes(placed),
               rank_moment_bytes=_rank_bytes(opt.m) + _rank_bytes(opt.v),
               param_bytes=n_params * 4)
    check(all(t.sharding == sh for t, sh in zip(tree_leaves(placed), tree_leaves(shardings))),
          f"tp_train {name}: the params keep their layouts")
    if hold_update:
        row.update(m_gap=_leaf_gaps(opt.m, opt_ref.m), v_gap=_leaf_gaps(opt.v, opt_ref.v),
                   param_max_abs_diff=max(float((p.full() - q).abs().max()) for p, q in zip(
                       tree_leaves(placed), tree_leaves(params))))
        del placed, opt
        dp_placed = device_put(params, params_shardings(params, mesh))
        dp_opt = adamw_init(params)
        sharded_train_step(model.loss, dp_placed, dp_opt, blocks[0], mesh=mesh,
                           lr=TP_TRAIN_LR)  # warm
        row["data_parallel_step_ms"], _ = _wall_ms(lambda: sharded_train_step(
            model.loss, dp_placed, dp_opt, blocks[0], mesh=mesh, lr=TP_TRAIN_LR))
        del dp_placed, dp_opt
    emit(row)
    check(row["loss_gap_rel"] <= TP_TRAIN_LOSS_RTOL,
          f"tp_train {name}: loss {row['loss_gap_rel']} > {TP_TRAIN_LOSS_RTOL} relative")
    check(row["grad_gap"] <= TP_TRAIN_TREE_TOL,
          f"tp_train {name}: gradients {row['grad_gap']} > {TP_TRAIN_TREE_TOL}")
    if hold_update:
        check(row["m_gap"] <= TP_TRAIN_TREE_TOL and row["v_gap"] <= TP_TRAIN_TREE_TOL,
              f"tp_train {name}: moments {row['m_gap']}, {row['v_gap']} > {TP_TRAIN_TREE_TOL}")
        check(row["param_max_abs_diff"] <= 2 * TP_TRAIN_LR,
              f"tp_train {name}: params {row['param_max_abs_diff']} > 2·lr")
    return row


def _train_blocks(cfg, steps: int, nblocks: int, rows: int, seq: int, seed: int,
                  dev: torch.device) -> list:
    """Each step's seeded tokens and labels ``(nblocks, rows, seq)``, and
    the stubbed frontend's output where the config has one: whisper's
    ``frames`` ``(nblocks, rows, encoder_seq, d_model)``, the vlm's
    ``image_embeds`` ``(nblocks, rows, image_tokens, image_embed_dim)``, f32
    normals drawn on the card."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    memory = {"audio": ("frames", cfg.encoder_seq, cfg.d_model),
              "vlm": ("image_embeds", cfg.image_tokens, cfg.image_embed_dim)}.get(cfg.family)
    steps_blocks = []
    for _ in range(steps):
        blk = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (nblocks, rows, seq)),
                                  device=dev) for k in ("tokens", "labels")}
        if memory is not None:
            name, m, width = memory
            blk[name] = torch.randn((nblocks, rows, m, width), generator=gen, device=dev)
        steps_blocks.append(blk)
    return steps_blocks


#: every cross-attention ``gate`` of a tp_train row: both packages draw it
#: 0, and ``tanh(0)`` silences the cross layers, so every gradient of their
#: projections and of the encoder would be 0 and checked nothing
TP_TRAIN_GATE = 0.5


def _with_gates(params):
    """``params`` with every cross ``gate`` leaf at :data:`TP_TRAIN_GATE`."""
    def walk(node):
        if isinstance(node, dict):
            return {k: node[k].fill_(TP_TRAIN_GATE) if k == "gate" else walk(node[k])
                    for k in node}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def _memory_path_leaves(tree) -> list:
    """(path, leaf) of the encoder's and the cross layers' leaves of a
    params or gradients tree."""
    from repro_torch._pytree import tree_leaves
    from repro_torch.distributed.sharding import _map_with_path

    names: list[str] = []
    _map_with_path(lambda path, _: names.append("/".join(map(str, path))), tree)
    cross = {n.rsplit("/", 1)[0] for n in names if n.endswith("/wk_mem")}
    return [(n, leaf) for n, leaf in zip(names, tree_leaves(tree))
            if n.startswith("enc_") or n.rsplit("/", 1)[0] in cross]


def tp_train_phase(seed: int, dev: torch.device, card: str) -> dict:
    """The train step tensor-parallel over ``model`` under ``train_rules``
    and ``train_rules_sp``
    (``repro_torch.distributed.sharded_train_step(..., rules=...)``), every
    rank a position on ``dev``, against the unsharded step, within
    ``TP_TRAIN_TIMEOUT_S``."""
    return _guarded(lambda: _tp_train(seed, dev, card), TP_TRAIN_TIMEOUT_S, "tp_train")


def _tp_train(seed: int, dev: torch.device, card: str) -> dict:
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import _preset

    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()
    t_phase = time.perf_counter()
    threads = _backward_threads(dev)
    emit({"phase": "tp_train", "run": "backward_threads", "card": card, **threads})
    check(threads["segments_exact"], "tp_train: the segmented backward's gradients are exact")
    check(not threads["node_backward_in_a_rank_thread"] and len(threads["node_errors"]) == 2,
          f"tp_train: a collective node's CUDA backward ran off its rank thread and raised "
          f"({threads})")

    lm = dataclasses.replace(_preset("lm100m"), dtype="float32")
    blocks = _train_blocks(lm, TP_TRAIN_STEPS, TP_TRAIN_LM_BLOCKS, TRAIN_BATCH // TRAIN_BLOCKS,
                           TRAIN_SEQ, seed, dev)
    seconds = {}
    for shape, axes in TP_TRAIN_MESHES:
        t0 = time.perf_counter()
        _tp_train_rows(f"lm100m/{'x'.join(map(str, shape))}", lm, shape, axes, blocks, seed,
                       dev, card, hold_update=True)
        seconds[f"lm100m/{'x'.join(map(str, shape))}"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bf16 = dataclasses.replace(lm, dtype="bfloat16")
    _tp_train_bf16("lm100m/bf16/1x4", bf16, blocks[0], seed, dev, card)
    seconds["lm100m/bf16/1x4"] = time.perf_counter() - t0
    del blocks
    gc.collect()
    torch.cuda.empty_cache()

    q = TP_TRAIN_QWEN3
    qwen3 = dataclasses.replace(get_config("qwen3-32b"), dtype="float32", num_layers=q["layers"])
    t0 = time.perf_counter()
    _tp_train_rows("qwen3-32b/1x4", qwen3, (1, 4), ("data", "model"),
                   _train_blocks(qwen3, 1, q["blocks"], q["rows"], q["seq"], seed, dev), seed,
                   dev, card, hold_update=False)
    seconds["qwen3-32b/1x4"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    seconds.update(_tp_train_families(seed, dev, card))
    seconds.update(_tp_train_sequence_parallel(seed, dev, card))
    launches = read_launches()
    emit({"phase": "tp_train", "run": "launches", "card": card, "launches": launches,
          "seconds": time.perf_counter() - t_phase, "seconds_by_run": seconds})
    return launches


def _tp_train_bf16(name: str, cfg, blk: dict, seed: int, dev: torch.device,
                           card: str) -> dict:
    """``cfg`` (bf16 compute over f32 master weights) on (1, 4): the
    tensor-parallel loss and gradients beside the unsharded step's, printed
    and not held (each rank's partial products round to bf16)."""
    from repro_torch.distributed import (
        device_put,
        params_shardings,
        tensor_parallel_gradients,
        train_rules,
    )
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import accumulate_gradients

    model = build_model(cfg)
    mesh = compat_make_mesh((1, 4), ("data", "model"), devices=(dev,))
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev, master=True)
    loss_ref, g_ref = accumulate_gradients(model.loss, params, blk)
    placed = device_put(params, params_shardings(params, mesh, fsdp_axis="data"))
    ms, (loss, g_tp) = _wall_ms(lambda: tensor_parallel_gradients(
        model.loss, placed, blk, mesh=mesh, rules=train_rules(mesh)))
    row = {"phase": "tp_train", "run": name, "card": card, "loss": float(loss),
           "unsharded_loss": float(loss_ref),
           "loss_gap_rel": abs(float(loss) - float(loss_ref)) / abs(float(loss_ref)),
           "grad_gap": _leaf_gaps(g_tp, g_ref), "gradients_ms": ms}
    emit(row)
    check(math.isfinite(row["loss"]), f"tp_train {name}: a finite loss")
    return row


#: the SSM, MoE and hybrid rows: mamba2-1.3b at full width cut to 8 of 48
#: layers on (1, 4) (16 SSM heads a rank); mixtral at full width, 1 layer,
#: on (1, 4) and on (2, 2), where a rank's 512 tokens are not a whole
#: 1,024-token group (its token rows all-gathered over data); jamba's
#: period at its smoke width on (2, 2, 2) (a cut: its full-width period is
#: 13.3 B params, ≈213 GB with gradients and moments, past one card); each
#: 2 steps of 2 blocks of 2 × 512 tokens (mixtral's one block, jamba's one
#: block of 8 × 64: the script's time); and mixtral's
#: data-parallel step at its smoke width, capacity factor 1, on (2, 2, 2)
#: (a cut: the data-parallel program holds every param whole on each of
#: the 8 ranks, 8 × 13.7 GB of params and gradients at full width)
TP_TRAIN_FAMILY_STEPS = 2
TP_TRAIN_MAMBA2 = {"layers": 8, "blocks": 2, "rows": 2, "seq": 512}
TP_TRAIN_MIXTRAL = {"layers": 1, "blocks": 1, "rows": 2, "seq": 512,
                    "meshes": (((1, 4), ("data", "model")), ((2, 2), ("data", "model")))}
TP_TRAIN_JAMBA_SMOKE = {"blocks": 1, "rows": 8, "seq": 64}
TP_TRAIN_DP_MOE = {"blocks": 2, "rows": 8, "seq": 128, "capacity_factor": 1.0}
#: the MLA, vision and audio rows, every cross ``gate`` at
#: :data:`TP_TRAIN_GATE`: deepseek-v2-236b at full width cut to its first
#: layer (MLA: 128 heads, 32 a rank, and the dense SwiGLU at 12,288; 1.39 B
#: params: its second layer brings a 160-expert MoE, 5.36 B params, ≈86 GB
#: with gradients and moments, past one card) on (1, 4); deepseek-v2's
#: three smoke layers (MLA beside the shared-expert MoE; a width cut) on
#: (2, 2, 2), 4 × 256 tokens so that the 4 data-parallel ranks get a row
#: each; llama-3.2-vision-11b at full width cut to one period of 5 of 40
#: layers (4 self-attention layers and the cross layer: 2.14 B params; 8 q
#: and 2 kv heads a rank, so ``wk_mem``/``wv_mem`` are split), its
#: ``image_embeds`` (rows, 1600, 4096), on (1, 4); whisper-tiny whole (4 +
#: 4 layers, 41.2 M params), its ``frames`` (rows, 1500, 384), on (2, 2)
#: (3 heads a rank) and on (1, 4) (6 heads do not divide 4: attention whole
#: on every rank, the MLP and the vocabulary split); each 2 steps of one
#: block of 2 × 512 tokens
TP_TRAIN_DEEPSEEK_V2 = {"layers": 1, "blocks": 1, "rows": 2, "seq": 512}
TP_TRAIN_DEEPSEEK_V2_SMOKE = {"blocks": 1, "rows": 4, "seq": 256}
TP_TRAIN_VLM = {"layers": 5, "blocks": 1, "rows": 2, "seq": 512}
TP_TRAIN_WHISPER = {"blocks": 1, "rows": 2, "seq": 512,
                    "meshes": (((2, 2), ("data", "model")), ((1, 4), ("data", "model")))}


def _host_tree(tree):
    """A copy of ``tree`` on the host, in page-locked memory: a copy into
    fresh pageable memory runs far below the link's rate, and the caching
    host allocator hands the next step the blocks this one frees
    (:func:`_release_host_cache` returns them after a row)."""
    from repro_torch._pytree import tree_map

    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
        t.detach()), tree)


def _release_host_cache() -> None:
    """Return the caching host allocator's page-locked blocks to the host."""
    torch._C._host_emptyCache()


def _recorded_routes(fn, *, margins: bool = True):
    """``fn()`` with ``moe_mlp.routes`` on and, with ``margins``, the
    router's margins recorded (:func:`_recording_margins`, the forward's
    calls only: a recomputation records no route): (result, routes,
    margins), the routes and margins on the host."""
    import repro_torch.models.moe as moe

    moe.moe_mlp.routes = []
    real, found = moe._route, []

    def route(p, cfg, xt):
        if margins and moe._recording():
            with torch.no_grad():  # nothing saved that a recomputation would not save
                logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)
                top = logits.topk(cfg.moe_top_k + 1, -1).values
                found.append((top[..., -2] - top[..., -1]).reshape(-1).cpu())
        return real(p, cfg, xt)

    moe._route = route
    try:
        out = fn()
        routes = [{k: v.cpu() for k, v in r.items()} for r in moe.moe_mlp.routes]
    finally:
        moe._route = real
        moe.moe_mlp.routes = None
    return out, routes, found


def _step_route_flips(routes, want, margins) -> dict:
    """Tokens whose expert set differs between ``routes`` and ``want`` (the
    unsharded run's, with its router ``margins``), and those whose drops
    differ; each flip's unsharded margin."""
    flips, drops, flip_margins = 0, 0, []
    for r, w, m in zip(routes, want, margins):
        moved = (r["experts"].sort(-1).values != w["experts"].sort(-1).values).any(-1)
        flips += int(moved.sum())
        drops += int((r["dropped"] != w["dropped"]).any(-1).sum())
        flip_margins += [float(x) for x in m.reshape(moved.shape)[moved]]
    return {"flips": flips, "drop_changes": drops, "flip_margins": flip_margins,
            "calls": len(routes), "calls_unsharded": len(want)}


def _tp_train_forced(name: str, cfg, mesh_shape: tuple, axes: tuple, blocks: list, seed: int,
                     dev: torch.device, card: str, *, data_parallel: bool = False,
                     rules: str = "train_rules", beside: str | None = None) -> dict:
    """``cfg`` trained ``len(blocks)`` steps from one seeded init by
    ``sharded_train_step(..., rules=...)`` under ``rules`` (``"train_rules"``
    or ``"train_rules_sp"``) with every rank on
    ``dev`` (with ``data_parallel``: by the data-parallel step, no rules,
    ``data_parallel_gradients``, whose MoE ranks gather the batch's token
    rows and so run their backward in segments, ``spmd.data_parallel_scope``),
    each step held to the unsharded step taken from the same state:
    the sharded run's params and moments gathered whole, so that AdamW's
    ±lr moves of near-zero gradients whose sign the two runs round apart
    (its first step moves every element by lr whatever its gradient's
    size) do not compound into the later steps' comparisons.  Each step:
    the unsharded loss, gradients and routes (``accumulate_gradients``, the
    router's margins recorded), the tensor-parallel ones
    (``tensor_parallel_gradients``) held to them where the routes agree
    (every token's expert set, every drop) and printed where they do not
    (every flip must be at a near-tie of the unsharded router,
    ``ROUTE_NEAR_TIE``); the unsharded ``adamw_update``'s params and
    moments (:func:`_unsharded_update`, leaf by leaf) kept on the host,
    the sharded step's held to them where the
    routes agree.  The unsharded state never stays on the card beside the
    sharded step's.  ``beside``: the rules of one more step from the last
    state (``"train_rules"``), timed with its peak memory rise and census,
    unchecked, printed beside the row's own.  Emits one line."""
    import dataclasses

    from repro_torch._pytree import tree_leaves, tree_map
    from repro_torch.distributed import (
        data_parallel_gradients,
        device_put,
        params_shardings,
        sharded_train_step,
        tensor_parallel_gradients,
    )
    from repro_torch.distributed import sharding
    from repro_torch.distributed.spmd import collective_census, data_parallel_scope
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import accumulate_gradients, adamw_init

    model = build_model(cfg)
    moe = any(s.mlp == "moe" for seg in cfg.segments() for s in seg.period)
    mesh = compat_make_mesh(mesh_shape, axes, devices=(dev,))
    rules_name, rules = rules, None if data_parallel else getattr(sharding, rules)(mesh)
    params = _with_gates(model.init(torch.Generator(device=dev).manual_seed(seed), device=dev,
                                    master=True))
    n_params = sum(t.numel() for t in tree_leaves(params))
    shardings = params_shardings(params, mesh, fsdp_axis="data")
    placed = device_put(params, shardings)
    opt = adamw_init(params)  # the data-parallel step keeps its moments whole
    if not data_parallel:  # placed as the params lie, so the step copies none
        opt = dataclasses.replace(opt, m=device_put(opt.m, shardings),
                                  v=device_put(opt.v, shardings))
    accumulate_gradients(model.loss, params, blocks[0])  # warm
    del params

    def whole(tree):  # a copy: the unsharded step must not share the sharded run's storage
        return tree_map(lambda t: t.full() if hasattr(t, "full") else t.clone(), tree)

    def gradients(blk):
        if data_parallel:
            return data_parallel_gradients(model.loss, placed, blk, mesh=mesh)
        return tensor_parallel_gradients(model.loss, placed, blk, mesh=mesh, rules=rules)

    row = {"phase": "tp_train", "run": name, "card": card, "mesh": mesh.shape,
           "program": "data_parallel" if data_parallel else "tensor_parallel",
           "rules": None if data_parallel else rules_name,
           "params": n_params, "layers": cfg.num_layers, "dtype": cfg.dtype,
           "tokens_per_step": int(blocks[0]["tokens"].numel()), "steps": len(blocks),
           "reference": "the unsharded step from the sharded run's state, each step"}
    if data_parallel:
        dp = tuple(a for a in axes if a in ("pod", "data"))
        row["segmented"] = data_parallel_scope(model.loss, dp, mesh.axis_size(dp)).segmented
    losses, ref_losses, loss_gaps, grad_gaps, ms, ref_ms = [], [], [], [], [], []
    m_gaps, v_gaps, p_diffs, routes_by_step, held = [], [], [], [], []
    for s, blk in enumerate(blocks):
        full = whole(placed)
        (t_ref, (loss_ref, g_ref)), want, margins = _recorded_routes(
            lambda: _wall_ms(lambda: accumulate_gradients(model.loss, full, blk)))
        del full
        (loss_g, g_tp), routes, _ = _recorded_routes(lambda: gradients(blk), margins=False)
        flips = _step_route_flips(routes, want, margins) if moe else {
            "flips": 0, "drop_changes": 0, "flip_margins": [], "calls": 0, "calls_unsharded": 0}
        routes_by_step.append(flips)
        held.append(flips["flips"] == 0 and flips["drop_changes"] == 0)
        grad_gaps.append(_leaf_gaps(g_tp, g_ref))
        loss_gaps.append(abs(float(loss_g) - float(loss_ref)) / abs(float(loss_ref)))
        if s == 0:  # the encoder's and the cross layers' gradients, which a gate of 0 zeroes
            row["memory_path_leaves"] = len(_memory_path_leaves(g_tp))
            row["memory_path_zero_leaves"] = [n for n, g in _memory_path_leaves(g_tp)
                                              if not bool((g.full() != 0).any())]
        del g_tp
        ref_p, ref_m, ref_v = _unsharded_update(placed, opt, g_ref)
        del g_ref
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with collective_census() as census:
            t_tp, (placed, opt, loss) = _wall_ms(lambda: sharded_train_step(
                model.loss, placed, opt, blk, mesh=mesh, lr=TP_TRAIN_LR, rules=rules))
        peak = torch.cuda.max_memory_allocated(dev) - before
        losses.append(float(loss))
        ref_losses.append(float(loss_ref))
        loss_gaps.append(abs(float(loss) - float(loss_ref)) / abs(float(loss_ref)))
        ms.append(t_tp)
        ref_ms.append(t_ref)
        m_gaps.append(_leaf_gaps(opt.m, ref_m))
        v_gaps.append(_leaf_gaps(opt.v, ref_v))
        p_diffs.append(max(float((p.full() - q.to(dev)).abs().max()) for p, q in zip(
            tree_leaves(placed), tree_leaves(ref_p)) if q.numel()))
        del ref_p, ref_m, ref_v
        if s == 0:
            row["census_step"] = census
            row["peak_memory_rise_gb"] = peak / 1e9
    row.update(losses=losses, unsharded_losses=ref_losses, loss_gap_rel_by_step=loss_gaps,
               grad_gap_by_step=grad_gaps, m_gap_by_step=m_gaps, v_gap_by_step=v_gaps,
               param_max_abs_diff_by_step=p_diffs, routes_by_step=routes_by_step,
               held_by_step=held, step_ms=ms, unsharded_gradients_ms=ref_ms,
               step_vs_unsharded_gradients=statistics.median(ms) / statistics.median(ref_ms),
               rank_param_bytes=_rank_bytes(placed), param_bytes=n_params * 4)
    if not data_parallel:
        row["rank_moment_bytes"] = _rank_bytes(opt.m) + _rank_bytes(opt.v)
    if beside is not None:  # one step of the other rules from the last state, as it lies
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with collective_census() as census:
            t_b, (placed, opt, _) = _wall_ms(lambda: sharded_train_step(
                model.loss, placed, opt, blocks[-1], mesh=mesh, lr=TP_TRAIN_LR,
                rules=getattr(sharding, beside)(mesh)))
        row["beside"] = {"rules": beside, "step_ms": t_b, "own_last_step_ms": ms[-1],
                         "census_step": census,
                         "peak_memory_rise_gb": (torch.cuda.max_memory_allocated(dev)
                                                 - before) / 1e9}
    emit(row)
    check(all(t.sharding == sh for t, sh in zip(tree_leaves(placed), tree_leaves(shardings))),
          f"tp_train {name}: the params keep their layouts")
    check(not data_parallel or not moe or row["segmented"],
          f"tp_train {name}: the MoE data-parallel ranks run their backward in segments")
    cross = any(s.mixer == "cross_attn" for seg in cfg.segments() for s in seg.period)
    check(not cross or (row["memory_path_leaves"] and not row["memory_path_zero_leaves"]),
          f"tp_train {name}: zero gradients of the encoder or cross layers: "
          f"{row.get('memory_path_zero_leaves')}")
    for s, flips in enumerate(routes_by_step):
        check(flips["calls"] == flips["calls_unsharded"],
              f"tp_train {name}: step {s} recorded {flips['calls']} routes, the unsharded "
              f"step {flips['calls_unsharded']}")
        check(all(m < ROUTE_NEAR_TIE for m in flips["flip_margins"]),
              f"tp_train {name}: step {s} flipped a route past {ROUTE_NEAR_TIE}: "
              f"{flips['flip_margins']}")
        if not held[s]:
            continue
        gaps = loss_gaps[2 * s:2 * s + 2]
        check(max(gaps) <= TP_TRAIN_LOSS_RTOL,
              f"tp_train {name}: step {s} loss {gaps} > {TP_TRAIN_LOSS_RTOL} relative")
        check(grad_gaps[s] <= TP_TRAIN_TREE_TOL,
              f"tp_train {name}: step {s} gradients {grad_gaps[s]} > {TP_TRAIN_TREE_TOL}")
        check(m_gaps[s] <= TP_TRAIN_TREE_TOL and v_gaps[s] <= TP_TRAIN_TREE_TOL,
              f"tp_train {name}: step {s} moments {m_gaps[s]}, {v_gaps[s]} > "
              f"{TP_TRAIN_TREE_TOL}")
        check(p_diffs[s] <= 2 * TP_TRAIN_LR,
              f"tp_train {name}: step {s} params {p_diffs[s]} > 2·lr")
    del placed, opt
    _release_host_cache()
    return row


def _unsharded_update(placed, opt, grads) -> tuple:
    """``adamw_update`` of the sharded run's state (its params and moments
    gathered whole) by the unsharded ``grads``, clipped by their global
    norm as the whole-tree update clips them, one leaf at a time, so that
    only one leaf's whole copies stand beside the sharded state on the
    card (qwen3-32b's 2.1 B f32 params at full width); each result in
    page-locked host memory (:func:`_host_tree`): (params, m, v)."""
    import dataclasses
    import math

    from repro_torch._pytree import tree_leaves, tree_map
    from repro_torch.optim import adamw_update
    from repro_torch.optim.adamw import global_norm

    def whole(t):  # a copy: adamw_update writes in place
        return t.full() if hasattr(t, "full") else t.clone()

    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full_like(gnorm, 1.0) / torch.clamp(gnorm, min=1e-12), max=1.0)
    done = []
    for p, m, v, g in zip(tree_leaves(placed), tree_leaves(opt.m), tree_leaves(opt.v),
                          tree_leaves(grads)):
        state = dataclasses.replace(opt, m=[whole(m)], v=[whole(v)])
        new_p, new_opt = adamw_update([whole(p)], [g.to(torch.float32) * scale], state,
                                      lr=TP_TRAIN_LR, clip_norm=math.inf)
        done.append(_host_tree((new_p[0], new_opt.m[0], new_opt.v[0])))
        del state, new_p, new_opt
    trees = []
    for i in range(3):
        it = iter(d[i] for d in done)
        trees.append(tree_map(lambda _: next(it), opt.m))
    return tuple(trees)


def _tp_train_families(seed: int, dev: torch.device, card: str) -> dict:
    """The SSM, MoE and hybrid rows (``TP_TRAIN_MAMBA2``, ``TP_TRAIN_MIXTRAL``,
    ``TP_TRAIN_JAMBA_SMOKE``, ``TP_TRAIN_DP_MOE``) and the MLA, vision and
    audio rows (:func:`_tp_train_memory_families`); returns each row's
    seconds."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config

    seconds = {}

    def timed(key, fn, *args, **kwargs):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        seconds[key] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()

    steps = TP_TRAIN_FAMILY_STEPS
    m = TP_TRAIN_MAMBA2
    mamba2 = dataclasses.replace(get_config("mamba2-1.3b"), dtype="float32",
                                 num_layers=m["layers"])
    timed("mamba2-1.3b/1x4", _tp_train_forced, "mamba2-1.3b/1x4", mamba2, (1, 4),
          ("data", "model"), _train_blocks(mamba2, steps, m["blocks"], m["rows"], m["seq"],
                                           seed, dev), seed, dev, card)
    x = TP_TRAIN_MIXTRAL
    mixtral = dataclasses.replace(get_config("mixtral-8x7b"), dtype="float32",
                                  num_layers=x["layers"])
    blocks = _train_blocks(mixtral, steps, x["blocks"], x["rows"], x["seq"], seed, dev)
    for shape, axes in x["meshes"]:
        key = f"mixtral-8x7b/{'x'.join(map(str, shape))}"
        timed(key, _tp_train_forced, key, mixtral, shape, axes, blocks, seed, dev, card)
    j = TP_TRAIN_JAMBA_SMOKE
    jamba = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"), dtype="float32")
    timed("jamba-v0.1-52b/smoke/2x2x2", _tp_train_forced, "jamba-v0.1-52b/smoke/2x2x2", jamba,
          (2, 2, 2), ("pod", "data", "model"),
          _train_blocks(jamba, steps, j["blocks"], j["rows"], j["seq"], seed, dev), seed, dev,
          card)
    d = TP_TRAIN_DP_MOE
    small = dataclasses.replace(get_smoke_config("mixtral-8x7b"), dtype="float32",
                                moe_capacity_factor=d["capacity_factor"])
    timed("mixtral-8x7b/smoke/data_parallel/2x2x2", _tp_train_forced,
          "mixtral-8x7b/smoke/data_parallel/2x2x2", small, (2, 2, 2), ("pod", "data", "model"),
          _train_blocks(small, steps, d["blocks"], d["rows"], d["seq"], seed, dev), seed, dev,
          card, data_parallel=True)
    seconds.update(_tp_train_memory_families(seed, dev, card))
    return seconds


def _tp_train_memory_families(seed: int, dev: torch.device, card: str) -> dict:
    """The MLA, vision and audio rows (``TP_TRAIN_DEEPSEEK_V2``,
    ``TP_TRAIN_DEEPSEEK_V2_SMOKE``, ``TP_TRAIN_VLM``, ``TP_TRAIN_WHISPER``),
    each step held to the unsharded step from the sharded run's state
    (:func:`_tp_train_forced`); returns each row's seconds."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config

    seconds = {}
    steps = TP_TRAIN_FAMILY_STEPS

    def row(key, cfg, mesh_shape, axes, shape):
        blocks = _train_blocks(cfg, steps, shape["blocks"], shape["rows"], shape["seq"], seed,
                               dev)
        t0 = time.perf_counter()
        _tp_train_forced(key, cfg, mesh_shape, axes, blocks, seed, dev, card)
        seconds[key] = time.perf_counter() - t0
        del blocks
        gc.collect()
        torch.cuda.empty_cache()

    d = TP_TRAIN_DEEPSEEK_V2
    row("deepseek-v2-236b/1x4", dataclasses.replace(get_config("deepseek-v2-236b"),
                                                    dtype="float32", num_layers=d["layers"]),
        (1, 4), ("data", "model"), d)
    row("deepseek-v2-236b/smoke/2x2x2",
        dataclasses.replace(get_smoke_config("deepseek-v2-236b"), dtype="float32"), (2, 2, 2),
        ("pod", "data", "model"), TP_TRAIN_DEEPSEEK_V2_SMOKE)
    v = TP_TRAIN_VLM
    row("llama-3.2-vision-11b/1x4", dataclasses.replace(
        get_config("llama-3.2-vision-11b"), dtype="float32", num_layers=v["layers"]),
        (1, 4), ("data", "model"), v)
    w = TP_TRAIN_WHISPER
    whisper = dataclasses.replace(get_config("whisper-tiny"), dtype="float32")
    for shape, axes in w["meshes"]:
        row(f"whisper-tiny/{'x'.join(map(str, shape))}", whisper, shape, axes, w)
    return seconds


#: the sequence-parallel rows (``train_rules_sp``: the residual stream
#: between blocks split by sequence over ``model``), each held as the
#: ``train_rules`` rows are (:func:`_tp_train_forced`) and followed by one
#: ``train_rules`` step from its last state, timed beside its own:
#: qwen3-32b at full width, 1 layer, one step of 2 blocks of 2 × 512 (as
#: ``TP_TRAIN_QWEN3``); mixtral-8x7b at full width, 1 layer, and
#: mamba2-1.3b at full width, 2 layers, on (1, 4); whisper-tiny whole on
#: (1, 4) (attention whole on each rank, its 1,500 frames 375 a rank, 512
#: tokens 128 a rank); deepseek-v2's and the vlm's smoke configs on (2, 2,
#: 2), every cross ``gate`` at ``TP_TRAIN_GATE``; 2 steps of one block but
#: qwen3's
TP_TRAIN_SP = (
    ("qwen3-32b", "full", {"layers": 1, "steps": 1, "blocks": 2, "rows": 2, "seq": 512},
     (1, 4), ("data", "model")),
    ("mixtral-8x7b", "full", {"layers": 1, "steps": 2, "blocks": 1, "rows": 2, "seq": 512},
     (1, 4), ("data", "model")),
    ("mamba2-1.3b", "full", {"layers": 2, "steps": 2, "blocks": 1, "rows": 2, "seq": 512},
     (1, 4), ("data", "model")),
    ("whisper-tiny", "full", {"steps": 2, "blocks": 1, "rows": 2, "seq": 512},
     (1, 4), ("data", "model")),
    ("deepseek-v2-236b", "smoke", {"steps": 2, "blocks": 1, "rows": 4, "seq": 256},
     (2, 2, 2), ("pod", "data", "model")),
    ("llama-3.2-vision-11b", "smoke", {"steps": 2, "blocks": 1, "rows": 4, "seq": 256},
     (2, 2, 2), ("pod", "data", "model")),
)


def _tp_train_sequence_parallel(seed: int, dev: torch.device, card: str) -> dict:
    """The ``train_rules_sp`` rows of :data:`TP_TRAIN_SP`, each step held to
    the unsharded step from the sharded run's state
    (:func:`_tp_train_forced`), a ``train_rules`` step beside; returns each
    row's seconds."""
    import dataclasses

    from repro_torch.configs import get_config, get_smoke_config

    seconds = {}
    for arch, width, shape, mesh_shape, axes in TP_TRAIN_SP:
        cfg = dataclasses.replace((get_config if width == "full" else get_smoke_config)(arch),
                                  dtype="float32")
        if "layers" in shape:
            cfg = dataclasses.replace(cfg, num_layers=shape["layers"])
        key = f"{arch}{'' if width == 'full' else '/smoke'}/{'x'.join(map(str, mesh_shape))}/sp"
        blocks = _train_blocks(cfg, shape["steps"], shape["blocks"], shape["rows"],
                               shape["seq"], seed, dev)
        t0 = time.perf_counter()
        _tp_train_forced(key, cfg, mesh_shape, axes, blocks, seed, dev, card,
                         rules="train_rules_sp", beside="train_rules")
        seconds[key] = time.perf_counter() - t0
        del blocks
        gc.collect()
        torch.cuda.empty_cache()
    return seconds


SAMPLED_STEPS = 8


# ---------------------------------------------------------------------------
# dryrun: the shape-only dry-run held against the card
# ---------------------------------------------------------------------------

DRYRUN_MESHES = ("single_pod", "multi_pod")
#: the measured step must take no less than the count's compute term; a
#: phase over this many seconds is reported (it overlaps the matrix, traced
#: in worker processes, with the card's checks)
DRYRUN_PHASE_S = 60.0
#: the archs whose cells take the workers longest (MoE dispatch groups)
DRYRUN_SLOW = ("jamba-v0.1-52b", "mixtral-8x7b", "deepseek-v2-236b")


def dryrun_cells(label: str, arch: str, shape: str) -> tuple[list, list]:
    """``run_matrix`` and ``run_probe_matrix`` (the depth fit) of one cell,
    on a production mesh of ``meta`` positions: a worker process's task."""
    from repro_torch.launch.dryrun_lib import run_matrix, run_probe_matrix
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(multi_pod=label == "multi_pod", devices=(torch.device("meta"),))
    cells = [(label, mesh)]
    return (run_matrix([arch], [shape], cells, verbose=False),
            run_probe_matrix([arch], [shape], cells, verbose=False))


def _median_event_ms(fn, runs: int = 3) -> float:
    """Median of ``runs`` warm runs of ``fn``, each between two CUDA events."""
    fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _meta_against_card(name: str, meta_step, card_step, card: str) -> dict:
    """One step counted on ``meta`` and on the card (equal), timed on the
    card, and its H100 roofline terms beside the time.  ``launches`` are the
    counted run's, ``timed_launches`` the timed runs' (warm-up included)."""
    from repro_torch.analysis.roofline import H100_SXM
    from repro_torch.launch.dryrun_lib import count_cost

    _, meta = count_cost(meta_step)
    before = read_launches()
    _, on_card = count_cost(card_step)
    torch.cuda.synchronize()
    counted = read_launches()
    ms = _median_event_ms(card_step)
    timed = read_launches()
    compute_ms = 1e3 * on_card.flops / H100_SXM.peak_flops
    memory_ms = 1e3 * on_card.bytes_accessed / H100_SXM.hbm_bw
    row = {"phase": "dryrun", "run": name, "card": card,
           "flops": on_card.flops, "bytes_accessed": on_card.bytes_accessed,
           "meta_flops": meta.flops, "meta_bytes_accessed": meta.bytes_accessed,
           "kernels": on_card.kernels, "meta_kernels": meta.kernels, "ops": on_card.ops,
           "launches": {k: counted[k] - before[k] for k in counted},
           "timed_launches": {k: timed[k] - counted[k] for k in timed},
           "ms": ms, "compute_ms": compute_ms,
           "memory_ms": memory_ms, "roofline_fraction": max(compute_ms, memory_ms) / ms}
    emit(row)
    check((meta.flops, meta.bytes_accessed, meta.kernels)
          == (on_card.flops, on_card.bytes_accessed, on_card.kernels),
          f"dryrun {name}: the meta count equals the card's ({row})")
    check(compute_ms <= ms, f"dryrun {name}: the H100 compute term {compute_ms} ms is at most "
                            f"the measured {ms} ms")
    return row


WRAPPER_HOST_ROUNDS = 3


def wrapper_host_ms(seed: int, dev: torch.device, sinks=(False,)) -> dict:
    """``host_ms`` (``device_and_host_ms``) of the flash and SSD wrappers at
    the kernels line's shapes, ``WRAPPER_HOST_ROUNDS`` times each, with no
    cost sink (``False``) and with one open (``True``), the order turned
    each round.  Also ``--wrapper-host-ms``, which times a checkout's own
    wrappers without a sink."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    b, l = SERVE_BATCH, SERVE_PROMPT
    q, k, v = normal(b, l, 64, 128), normal(b, l, 8, 128), normal(b, l, 8, 128)
    nh, p, n = 64, 64, 128
    dt = (torch.rand((b, l, nh), generator=gen, device=dev) * 0.8 + 0.1).to(torch.bfloat16)
    a = (-(torch.rand((nh,), generator=gen, device=dev) + 0.5)).to(torch.bfloat16)
    ssd = (normal(b, l, nh, p), dt, a, normal(b, l, n), normal(b, l, n))
    calls = {"flash_attention": lambda: fa.flash_attention(q, k, v, causal=True),
             "ssd_scan": lambda: ss.ssd_scan(*ssd, chunk=256)}
    out = {name: {("sink" if s else "none"): [] for s in sinks} for name in calls}
    for r in range(WRAPPER_HOST_ROUNDS):
        for s in (sinks if r % 2 == 0 else sinks[::-1]):
            for name, fn in calls.items():
                if s:
                    from repro_torch.kernels._build import recording_costs

                    with recording_costs():
                        host = device_and_host_ms(fn)[1]
                else:
                    host = device_and_host_ms(fn)[1]
                out[name]["sink" if s else "none"].append(host)
    return {"rounds": WRAPPER_HOST_ROUNDS, "host_ms": out}


def dryrun_phase(seed: int, dev: torch.device, card: str) -> dict:
    """The dry-run (``repro_torch.launch.dryrun_lib``) held against the card:
    counts on ``meta`` and on the card, its compute term below the measured
    step, its argument bytes against the allocator, and the whole matrix."""
    import dataclasses
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from repro_torch._pytree import tree_leaves, tree_map
    from repro_torch.configs import ARCH_IDS, SHAPES, get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.dryrun_lib import cell_skip_reason, lower_cell
    from repro_torch.launch.mesh import compat_make_mesh
    from repro_torch.launch.train import _preset
    from repro_torch.models import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    reset_launches()  # the phase's launches: counted from 0, read at its end
    t_phase = time.perf_counter()
    meta = torch.device("meta")
    workers = max(1, min(8, (os.cpu_count() or 2) - 1))
    pool = ProcessPoolExecutor(max_workers=workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        # the slowest cells first: the MoE and hybrid trains
        order = sorted(((label, arch, shape) for label in DRYRUN_MESHES for arch in ARCH_IDS
                        for shape in SHAPES),
                       key=lambda c: (c[2] != "train_4k", c[1] not in DRYRUN_SLOW, c))
        tasks = {cell: pool.submit(dryrun_cells, *cell) for cell in order}

        # ---- the serve phase's qwen3-32b prefill: meta against card ----
        spec = SERVE["qwen3-32b"]
        cfg = dataclasses.replace(get_config(spec["arch"]), **spec["overrides"])
        model = build_model(cfg)
        shape = ShapeCell("serve_prefill", "prefill", SERVE_PROMPT, SERVE_BATCH)

        def prefill_on(device, params):
            cache = model.init_cache(SERVE_BATCH, SERVE_PROMPT, torch.bfloat16, device=device)
            toks = torch.zeros((SERVE_BATCH, SERVE_PROMPT), dtype=torch.int32, device=device)
            return torch.no_grad()(lambda: model.prefill(params, {"tokens": toks}, cache))

        params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
        prefill = _meta_against_card("qwen3-32b_prefill",
                                     prefill_on(meta, model.init(None, device=meta)),
                                     prefill_on(dev, params), card)
        check(prefill["launches"]["flash_attention"] == cfg.num_layers
              and prefill["kernels"]["flash_attention"]["calls"] == cfg.num_layers,
              f"dryrun: the counted prefill launched flash once a layer with its formula "
              f"counted ({prefill['launches']}, {prefill['kernels']})")
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # ---- memory: the dry-run's argument bytes against the allocator ----
        one = compat_make_mesh((1, 1), ("data", "model"), devices=(meta,))
        argument_bytes = lower_cell(cfg, one, shape).memory["argument_bytes"]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(dev)
        params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
        params = tree_map(lambda t: t.to(torch.bfloat16), params)  # the dry-run's bf16 layout
        placed = (params, model.init_cache(SERVE_BATCH, SERVE_PROMPT, torch.bfloat16, device=dev),
                  torch.empty_like(model.input_specs(shape)["tokens"], device=dev))
        gc.collect()
        torch.cuda.synchronize()
        rise = torch.cuda.memory_allocated(dev) - before
        mem = {"phase": "dryrun", "run": "argument_bytes", "card": card,
               "argument_bytes": argument_bytes, "allocated_rise": rise,
               "leaves": len(tree_leaves(placed)), "rel_err": abs(rise - argument_bytes)
               / argument_bytes}
        emit(mem)
        check(mem["rel_err"] <= 0.01,
              f"dryrun: argument bytes within 1 % of the allocator's rise ({mem})")
        del params, placed
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the train phase's lm100m spliter step: meta against card ----
        mc = dataclasses.replace(_preset("lm100m"), attn_impl="flash")
        tr = Trainer(mc, TrainConfig(accum_mode="spliter", global_batch=TRAIN_BATCH,
                                     num_blocks=TRAIN_BLOCKS, seq_len=TRAIN_SEQ,
                                     steps=TRAIN_STEPS, peak_lr=1e-3, warmup_steps=2,
                                     seed=seed), device=dev)
        host_blocks = tr.pipeline.peek(0)

        def step_on(device, params):
            opt = adamw_init(params)
            blocks = {k: torch.as_tensor(v).to(device) for k, v in host_blocks.items()}
            return lambda: tr._update(params, opt, tr.gradients(params, blocks)[1])

        train = _meta_against_card(
            "lm100m_spliter_step",
            step_on(meta, tr.model.init(None, device=meta, master=True)),
            step_on(dev, tr.init_state()[0]), card)
        del tr
        gc.collect()
        torch.cuda.empty_cache()

        # ---- the flash and SSD wrappers' host work with no cost sink and
        # with one open ----
        emit({"phase": "dryrun", "run": "wrapper_host_ms", "card": card,
              **wrapper_host_ms(seed, dev, sinks=(False, True))})

        # ---- the matrix, traced in the workers meanwhile ----
        counts = {}
        for (label, arch, _), task in tasks.items():
            for kind, records in zip(("run", "probe"), task.result()):
                c = counts.setdefault(f"{label}/{kind}", {"OK": 0, "SKIP": 0, "FAIL": 0})
                for rec in records:
                    c[rec["status"]] += 1
                    want = cell_skip_reason(get_config(arch), SHAPES[rec["shape"]])
                    check(rec["status"] == ("SKIP" if want else "OK")
                          and rec.get("reason") == want,
                          f"dryrun {label}/{kind} {arch} {rec['shape']}: {rec['status']} "
                          f"{rec.get('reason') or rec.get('error', '')}")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    seconds = time.perf_counter() - t_phase
    emit({"phase": "dryrun", "run": "matrix", "card": card, "counts": counts,
          "workers": workers, "seconds": seconds, "under_limit": seconds < DRYRUN_PHASE_S})
    counted = {k: prefill["launches"][k] + train["launches"][k] for k in prefill["launches"]}
    emit({"phase": "dryrun", "run": "launches", "counted": counted,
          "phase_total": read_launches()})
    return counted


def sampled_serve_phase(seed: int, dev: torch.device) -> dict:
    """mamba2-1.3b cut to 2 layers, sampling: the reference's Threefry draws."""
    import dataclasses

    import numpy as np

    from repro_torch._threefry import categorical
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Server

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=np.int32)
    server = Server(cfg, max_len=SERVE_MAX_LEN, device=dev)
    server.load(params)
    tokens, stats, logits = server.generate(prompts, steps=SAMPLED_STEPS, greedy=False,
                                            return_logits=True)
    again, _ = server.generate(prompts, steps=SAMPLED_STEPS, greedy=False)
    served = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    drawn = torch.stack([categorical(t - 1, logits[:, t]) for t in range(1, SAMPLED_STEPS)], 1)
    greedy_first = torch.argmax(logits[:, 0], -1)
    result = {"phase": "sampled_serve", "arch": "mamba2-1.3b", "layers": cfg.num_layers,
              "steps": SAMPLED_STEPS, "logits_dtype": str(logits.dtype).removeprefix("torch."),
              "decode_ms_per_token": stats.decode_s / SAMPLED_STEPS * 1e3,
              "distinct_tokens": int(served.unique().numel())}
    emit(result)
    check(torch.equal(served[:, 0], greedy_first), "sampled serve: the first token is the argmax")
    check(torch.equal(served[:, 1:], drawn),
          "sampled serve: each token is _threefry.categorical of its step's served logits")
    check(np.array_equal(tokens, again), "sampled serve: a second run gives the same tokens")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--repeats", type=int, default=3, help="timed runs after one warm-up")
    ap.add_argument("--wrapper-host-ms", action="store_true",
                    help="only build the kernels and time the flash and SSD wrappers' host work "
                         "(no cost sink), for comparing two checkouts")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' products in f32
    torch.backends.cudnn.allow_tf32 = False
    clock = PhaseClock()

    from repro_torch.core.blocked import BlockedArray, round_robin_placement
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libraries = _build.build(verbose=True)  # prints registers/spills per kernel
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [p.name for p in libraries.values()]})
    emit({"phase": "ptxas", "kernels": ptxas_line(_build.REPORTS)})

    dev = torch.device("cuda", 0)
    if args.wrapper_host_ms:
        emit({"phase": "wrapper_host_ms", "card": card, "src": str(ROOT / "src"),
              **wrapper_host_ms(args.seed, dev)})
        return 0
    hist, km, means, label_counts = make_data(args.seed, dev)
    x_hist, x_km = (
        BlockedArray.from_array(a, BLOCK_ROWS, num_locations=LOCATIONS,
                                policy=round_robin_placement, device=dev)
        for a in (hist, km)
    )
    launches, per_call = clock("main_path", main_path, x_hist, x_km, means, label_counts,
                               args.seed, args.repeats)
    check(all(v > 0 for v in launches.values()), f"every kernel launched: {launches}")
    kernels = clock("kernel_checks", kernel_checks, x_hist, x_km, args.seed, launches, per_call)
    clock("threaded", threaded_phase, x_hist, x_km, args.seed, args.repeats)
    stream_launches = clock("stream", stream_phase, x_hist, x_km, args.seed, args.repeats)
    mesh_launches = clock("mesh", mesh_phase, x_hist, x_km, args.seed, args.repeats)
    service_launches = clock("service", service_phase, x_hist, x_km, args.seed, args.repeats)
    cluster_launches = clock("cluster", cluster_phase, x_hist, x_km, args.seed, args.repeats)
    for k in kernels:
        k["stream_launches"] = stream_launches[k["name"]]
    launches["partition_histogram"] = clock("value_histogram", value_histogram_phase, x_hist)
    x_values = torch.stack([x_hist.block(b) for b in x_hist.blocks_at(0)])
    del hist, km, means, label_counts, x_hist, x_km
    torch.cuda.empty_cache()

    by_run = {}  # each serve run's prefill launches (its f32 prefill's apart)

    def count(run: str, row: dict) -> None:
        by_run[run] = {k: row["launches"][k] for k in ("flash_attention", "ssd_scan")}
        if "f32_prefill_flash_split_launches" in row:
            by_run[f"{run}/f32"] = {
                "flash_attention_split": row["f32_prefill_flash_split_launches"],
                "split_kv": row["f32_prefill_split_kv_launches"]}

    for name, spec in SERVE.items():
        result = clock(f"serve/{name}", serve_phase, name, args.seed, dev)
        if not spec.get("depth_check"):
            count(name, result)
        torch.cuda.empty_cache()
    for name in MOE_SERVE:
        rows = clock(f"serve/{name}", moe_serve_phase, name, args.seed, dev)
        count(name, rows["dropless"])
        count(f"{name}/published", rows["published"])
        torch.cuda.empty_cache()
    for name in CROSS_SERVE:
        count(name, clock(f"serve/{name}", cross_serve_phase, name, args.seed, dev))
        torch.cuda.empty_cache()
    for k in ("flash_attention", "ssd_scan", "flash_attention_split", "split_kv"):
        launches[k] = sum(n.get(k, 0) for n in by_run.values())
    clock("sampled_serve", sampled_serve_phase, args.seed, dev)
    torch.cuda.empty_cache()
    clock("knn", knn_phase, args.seed, dev)
    clock("svm", svm_phase, args.seed, dev)
    torch.cuda.empty_cache()
    clock("moe", moe_phase, args.seed, dev)
    torch.cuda.empty_cache()
    train_launches = clock("train", train_phase, args.seed, dev, card)
    torch.cuda.empty_cache()
    distributed_launches = clock("distributed", distributed_phase, args.seed, dev, card)
    torch.cuda.empty_cache()
    tensor_parallel_launches = clock("tensor_parallel", tensor_parallel_phase, args.seed, dev,
                                     card)
    torch.cuda.empty_cache()
    long_decode_launches = clock("long_decode", long_decode_phase, args.seed, dev, card)
    torch.cuda.empty_cache()
    tp_train_launches = clock("tp_train", tp_train_phase, args.seed, dev, card)
    torch.cuda.empty_cache()
    dryrun_launches = clock("dryrun", dryrun_phase, args.seed, dev, card)
    kernels += clock("lm_kernel_checks", lm_kernel_checks, args.seed, dev, x_values, launches,
                     by_run)
    for k in kernels:  # launches on the mesh and service paths (None: not on them)
        k["mesh_launches"] = mesh_launches.get(k["name"])
        k["service_launches"] = service_launches.get(k["name"])
        k["cluster_launches"] = cluster_launches.get(k["name"])
        k["train_launches"] = train_launches[k["name"]]
        k["distributed_launches"] = distributed_launches[k["name"]]
        k["tensor_parallel_launches"] = tensor_parallel_launches[k["name"]]
        k["long_decode_launches"] = long_decode_launches[k["name"]]
        k["tp_train_launches"] = tp_train_launches[k["name"]]
        k["dryrun_launches"] = dryrun_launches[k["name"]]
    check(len(kernels) == 5 and all(k["launches"] > 0 for k in kernels),
          f"every kernel launched on its path: {launches}")
    check(launches["flash_attention_split"] > 0 and launches["split_kv"] > 0,
          f"the flash kernel's split route launched on the f32 prefill: {launches}")
    emit({"phase": "clock", "seconds_by_phase": clock.seconds, "gc_seconds": clock.gc_seconds,
          "seconds": time.perf_counter() - clock.start})
    emit({"kernels": kernels})
    torch.cuda.synchronize()
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
