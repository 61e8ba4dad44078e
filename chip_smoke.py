#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py               # the whole check, on GPU 0
    python3 chip_smoke.py --out DIR     # also write the compiler's report there

Phases, each printing one JSON line:

1. ``build``      compile the seven kernels (one nvcc each, in parallel);
                  the registers, spills and static shared memory of every
                  flash-attention, spmm, tiled pushsum_mix and dpps_perturb
                  instantiation (the mix tiles' dynamic shared memory from
                  ``ops.mix_plan``), and the registers and spills of every
                  pushsum_mix (N = 1..32), l1_norm, dpps_perturb and
                  flash_attention one (``-Xptxas -v``; any spill in those
                  fails).
2. ``kernels``    each kernel against its plain PyTorch version at the main
                  paths' shapes: the dense kernels at the paper MLP's shared
                  layer (N = 10, d_s = 7840) and the dense full-width buffer
                  (N = 5, d_s = 505,956,352), plus the Philox noise
                  statistics; the norm and the perturbation also at the
                  sparse paths' shapes (N = 24, d_s = 95,669,064 and
                  N = 128, d_s = 7840). The norm and the mix must give the
                  same bits on a second launch. At the two small shapes
                  the norm, the mix (paper shape) and their library calls
                  are also timed as host µs a call (1,000 calls, no
                  synchronise in between) and, after the last phase, device
                  µs a call (``torch.profiler``); the perturbation at the
                  paper shape too, beside its copy yardstick. ``spmm`` at
                  the sparse full width (N = 24, d_s = 95,669,064), the
                  sparse training shape (N = 128, d_s = 7840) and the
                  widest sparse sweep (N = 4096, D = 8), with the launch
                  plan of each (``ops.spmm_plan``: column
                  tiles or rows), and bit for bit against ``pushsum_mix``
                  at all three. The dense kernels also at the training
                  path's buffer (N = 4, d_s = 243,286,016). Beside the
                  perturbation, which no PyTorch call computes,
                  ``torch.add(s, eps, out=o)`` is timed as the copy
                  yardstick: the same bytes moved, no noise.
3. ``consensus``  ``Session.build(DOutGraph(5, 2), schedule="dense")`` then
                  ``run(20)`` over a (5, 505,956,352) f32 buffer, in one
                  call (timed), and one round a call (the error by round).
4. ``training``   PartPSP on the paper MLP (N = 10, 2-out, partpsp-1), 50
                  steps, dense schedule.
5. ``sparse_consensus``  ``Session.build(ErdosRenyiGraph(24, p=8/24),
                  schedule="sparse")`` then ``run(20)`` over a (24,
                  95,669,064) f32 buffer, as in phase 3.
6. ``sparse_training``   PartPSP on the paper MLP at N = 128 on ER(128,
                  p=8/128), sparse schedule, 50 steps.
7. ``tree_ops``   ``ops.l1_clip_tree`` and ``ops.laplace_noise_tree`` on the
                  sparse full-width tree, each against its plain version,
                  with the Laplace statistics.
8. ``agreement``  seeded consensus and training runs on the card (kernels)
                  and on the CPU (plain versions) agree, dense and sparse.
9. ``flash``      ``flash_attention`` against its plain version at the serving
                  shapes: (a) llama3.2-1b's prefill (B = 1, S = 32,768,
                  H = 32, K = 8, D = 64), (b) gemma3-1b's (H = 4, K = 1,
                  D = 256) with window 512 and global, (c) a ragged B = 2,
                  S = 1,000, H = 24, K = 8, D = 128, (d) zamba2-7b's shared
                  attention block (B = 1, S = 4,096, H = K = 32, D = 112),
                  and the rank shards of phases 31, 33 and 34 (34's at an
                  offset into a GQA group: ``FLASH_OFFSETS``);
                  the plain version over
                  windows of query rows (rows [r0, r1) against keys [0, r1)),
                  every row checked; SDPA timed as the yardstick at all
                  five (``is_causal``, or a banded boolean mask where
                  windowed). The bound is the 3xTF32 tensor-core one (three
                  TF32 products for each f32 one, 495 TFLOP/s);
                  ``f32_core_bound_ms`` keeps the f32 CUDA-core figure.
10. ``serve``     ``Session.build(model=...).serve`` of llama3.2-1b and then
                  gemma3-1b at full width (all layers, f32, flash_prefill)
                  on one 32,768-token prompt, 32 tokens generated.
11. ``serve_agreement``  llama3.2-1b at full width, 2 layers: serve on the
                  card (kernel) and on the CPU (plain) under the same Gumbel
                  noise; then flash against plain prefill on the card.
12. ``mix_wide``  ``pushsum_mix`` past its template (N = 33, 64, 256 at D =
                  2^20; N = 4096 at D = 8 and 128; N = 128 at D = 7936)
                  against its plain version, beside ``torch.matmul``; every
                  tile of ``ops.MIX_TILES`` at every shape giving the same
                  bits; bit for bit equal to the template kernel at N = 32
                  and to ``spmm`` on ER(64) and ER(4096).
13. ``dense_er4096``  ``Session.build(ErdosRenyiGraph(4096, p=8/4096,
                  seed=2024))`` with its default (dense) schedule, then
                  ``run(20)`` at d_s = 8 (bench_sparse.py's widest dense
                  point; the kernel path pads it to 128 lanes), beside the
                  sparse schedule on the same graph: ms a round, and
                  ``pushsum_mix`` launched once a round that is not a sync
                  round, on a tiled plan.
14. ``rows_wide`` the norm, the perturbation and the clip scale at N =
                  65,536 and 100,003 (d_s = 300) against their plain
                  versions; the perturbation's s_noise bit for bit the same
                  under every plan of ``PERTURB_PLANS`` at those short rows
                  and at long ones; one ``dpps_step`` on a 70,000-node
                  ring CSR.
15. ``transformer_training``  ``Session.build(DOutGraph(4, 2),
                  model=Transformer(llama3.2-1b), partition=its rules,
                  schedule="dense")`` at full width (16 layers, d_s =
                  243,286,016), ``train(5)`` on 2 x 1,024 synthetic tokens
                  a node: ms a step, tokens/s, gradient passes against the
                  DPPS round (CUDA events), peak memory, exact launches.
16. ``training_agreement``  the same model with 2 layers, 4 nodes, 3 steps,
                  noise through ``bits_at``: the card against the CPU.
17. ``serve`` of the other group kinds at full width on a 4,096-token
                  prompt, 32 tokens generated: llama-3.2-vision-11b (all
                  40 layers, 1,600 image tokens, gates at 0.5), xlstm-125m
                  at 1 of its 3 units and llama4-scout-17b-a16e at 4 of
                  its 48 layers (zamba2-7b serves in phases 18, 33 and 34,
                  for the script's time); as phase 10,
                  with each recurrent scan bracketed by CUDA events too (its
                  share of the prefill).
18. ``group_serve_agreement``  those kinds' five smoke configs (maverick's
                  moe_every = 2 among them) and zamba2-7b at full width with
                  one unit (flash at D = 112): the card against the CPU,
                  same parameters and Gumbel noise.
19. ``group_training``  PartPSP training of the other group kinds at
                  their published widths, 4 x 64 tokens a node, 3 steps,
                  2-out graph, dense schedule: (a) xlstm-125m, one of its
                  3 units, N = 4;
                  (b) zamba2-7b, one of its 11 units, N = 4; (c)
                  llama-3.2-vision-11b, one of its 8 units, 1,600 image
                  tokens, gates at 0.5, N = 2; each with phase 15's figures
                  and the recurrent loops' forward time; (d) llama4-scout,
                  one of its 48 layers: one node's loss and backward only
                  (PartPSP at N = 2 does not fit one card).
20. ``checkpoint_serve``  run b's consensus saved by
                  ``Session.save_consensus``, restored as ``launch/serve.py
                  --checkpoint`` restores it, and served (512-token prompt,
                  8 tokens, flash at D = 112): logits bit for bit those of
                  serving the in-memory ``consensus_view``.
21. ``group_training_agreement``  the five smoke configs of phase 18
                  trained 3 rounds on the card and on the CPU, noise off and
                  on (the same Philox rows), every MoE token's routing
                  margin above 1e-4.
22. ``loop_training``  phase 15's session (llama3.2-1b at full width, N =
                  4, its shared layer-stacked leaves), ``train(3,
                  driver="loop")`` (the pytree runtime: a kernel launch a
                  shared leaf) under ``LedgerHook``, ``BudgetHook``,
                  ``MetricsHook`` and ``RealSensitivityHook``, then
                  ``driver="engine"`` with the same hooks, batches and seed:
                  ms a step, a DPPS round and the hooks' captures for both,
                  exact launches a leaf, loop against engine, the ledgers'
                  accounting equal, no real-sensitivity violation, peak
                  memory; at llama's leaves (dense gossip) and the paper
                  MLP's layers with bias vectors (sparse gossip on ER(128);
                  leaves that start at col0 % 4 == 2), ``l1_norm_tree``,
                  ``dpps_perturb_tree`` and the kernel gossip a leaf each
                  against its plain version, and each tree perturbation
                  launch bit for bit against the packed launch's columns;
                  the paper MLP on ER(128), sparse schedule, loop against
                  engine for 5 steps (``spmm`` a leaf), noise on and off.
23. ``resume``    on phase 15's session cut to its 4 shared layers (the
                  engine, an 8.1 GB state): 2 rounds,
                  ``Session.save``, ``Session.restore`` into a fresh
                  template, 1 more round, bit for bit 3 uninterrupted rounds
                  in state and trajectory; the checkpoint's GB and the save
                  and load seconds (a temporary directory, removed).
24. ``faults``    ``FaultModel(drop_rate=0.2, straggler_rate=0.1, churn=((4,
                  5, 12),))``: (a) ``run(20)`` at the dense full width (the
                  "dynamic" schedule) and (b) at the sparse full width
                  (ER(24)), ms a round beside phases 3 and 5, the host ms
                  of realizing a round's weights, mean(a) = 1, node 4
                  isolated in its window, ``pushsum_mix`` bit for bit its
                  plain version on a realized W and ``spmm`` on realized
                  values (bit for bit ``pushsum_mix`` there too); (c) phase
                  15's session under drop 0.2 and stragglers 0.25, 3 steps
                  with ``LedgerHook`` and ``NetworkStatsHook``: ms a step,
                  peak memory, the ledger's realized degrees, the network
                  summary; (d) the paper MLP on ER(128), dense and sparse,
                  5 steps by the loop and by the engine, noise on (masks,
                  ``a``, the losses and the ``net_*`` rows bit for bit, the
                  state to rtol 1e-4) and off (the state bit for bit).
25. ``async``     (a) DPPS consensus over llama3.2-1b's shared width (N =
                  4, d_s = 243,286,016), dense, ``DelayModel(max_delay=2,
                  timeout_rate=0.1, rates=(1, 2, 1, 1))`` with drop 0.1, 10
                  rounds: ms a round, peak memory beside its reckoning,
                  B + 1 mixes a round, mass 1 to 1e-5, staleness <= 2;
                  (b) the MLP on ER(128), sparse, delays and faults: the
                  loop, the pytree engine and the packed engine as in
                  24d; (c) 2 async rounds, ``Session.save``, restore, 1
                  round: bit for bit 3 rounds.
26. ``wire``      the wire codecs: (a) ``run(10)`` (cut from 20 for the
                  script's time limit) at the dense full width
                  (N = 5, d_s = 505,956,352) under ``int8`` and ``bf16``:
                  ms a round beside phase 3's raw f32 round, the time of
                  one round's stochastic-rounding draw and encode, peak
                  memory beside its reckoning, exact launches (a bf16
                  round launches no mix), mean(a) = 1 to 1e-5, the
                  compression ratio; (b) int8, bf16 and top-k consensus on
                  the card against the CPU (N = 10, d_s = 7840), int8 and
                  bf16 entries a quantum apart counted and bounded (int8
                  none, bf16 0.1 %), and the paper MLP
                  trained 10 steps under int8 and top-k, card against CPU
                  (losses to 1e-3); (c) phase 15's session
                  under int8, 3 steps with ``LedgerHook`` and
                  ``NetworkStatsHook``: ms a step beside phase 15's, the
                  ledger's codec and bytes; (d) ``topk:1/16`` on the paper
                  MLP (d_s = 7840), 50 steps, dense (N = 10) and sparse
                  (ER(128), ``spmm``): exact launches, the losses fall, the
                  residual's L1 bounded; (e) int8 under delays and drops
                  on ER(128); (f) a top-k state saved (``.dpps/.resid``),
                  restored and resumed bit for bit.
27. ``audit``     the attack battery at ``AuditConfig()``'s setting (N =
                  4, dim 16) with 800 trials (cut from 1,500 for the
                  script's time limit), each trial a ``run_dpps`` call on the
                  card): the default Laplace (``dpps_perturb.cu``), the
                  Gaussian, graph-homomorphic and half-scale Laplace
                  mechanisms (their draws through ``laplace_noise.cu``)
                  under the three threat models, each cell's empirical
                  epsilon, claim, flag and trials, the fig5 claims held;
                  ``LaplaceMechanism()`` bit for bit the default on 50
                  trials (a comparison: its launches stay out of the
                  kernels line); the wire battery (int8, top-k, the
                  compress-first codec, each on the kernels: the
                  compress-first codec's down-scaled noise through
                  ``laplace_noise.cu``) at 800 trials, its claims held;
                  the reconstruction table; membership inference on the
                  paper MLP. A mechanism's noise norm launches
                  ``dpps_perturb.cu`` alone (``ops.noise_l1_rows``),
                  counted apart as ``norm_only_launches`` in
                  ``dpps_perturb_rows``' entry.
28. ``obs``       the observability layer and the shared CLI, in a fresh
                  process (``--obs-phase``: the profiler drops device
                  events in a process that has run for minutes): (a)
                  ``Session.profile(3)`` at the dense (N = 5, d_s =
                  505,956,352) and the sparse (ER(24), d_s = 95,669,064)
                  full widths: a breakdown with no note whose phases sum
                  to the device total, each phase's ms a round beside
                  phase 3's and 5's kernel times, the passed state bit for
                  bit unchanged; the same rounds by ``run`` under
                  ``torch.profiler``, every ``l1_norm.cu`` launch in
                  ``dpps_perturb`` (round 0's norm of s^(0) in
                  ``dpps_sensitivity``, as the reference lays it out),
                  every ``dpps_perturb.cu`` launch in ``dpps_noise``,
                  every ``pushsum_mix.cu`` / ``spmm.cu`` launch in
                  ``dpps_gossip``; (b) ``Session.profile(1, batch_at=)``
                  of phase 15's llama3.2-1b session: the gradient phases'
                  share of the device time against the DPPS round's; (c)
                  phase 25's async consensus at llama's shared width, 20
                  rounds under ``WatchdogHook(strict=True)``,
                  ``TimelineHook``, ``MetricsHook``, a ``JsonlExporter``
                  and ``write_prometheus``: no alert, a valid Chrome trace
                  whose ``send->deliver`` counts sum to the delay
                  histogram's; (d) a NaN in one node's values aborts the
                  strict watchdog at round 0 (``nonfinite_wire``), and the
                  watchdog's cost a round at the dense full width; (e) two
                  ``Session.record`` s and ``registry.check`` pass, a
                  synthetic 2x ``us_per_round`` record is a regression;
                  (f) ``launch/train.py`` through ``api/cli.py``: 3 steps
                  of the reduced llama3.2-1b on ER(4, p = 0.5), drops
                  0.1, the int8 wire, ``--use-kernels``. Last, the paper
                  MLP's step and the ER(4096) round of this run (annotated
                  by ``phase()``) beside PERF.md's figures from before the
                  annotations.
29. ``launch``    the launch tooling (``repro_torch.launch``): (a) the dry
                  run (``python -m repro_torch.launch.dryrun --arch A
                  --nodes 16``) of all ten architectures x four shapes on
                  meta, one process an architecture, the card hidden from
                  them, niced, started together before phase 24 (with
                  33d's) so that they trace beside phases 24-28: every
                  row's FLOPs, bytes, peak and ``fits``, no error row, the
                  reference's skips, every ok row's FLOPs > 0, the wall
                  time and phase 29's wait; (b) phase 15's step (llama3.2-1b, N = 4, 2 x 1,024 tokens a
                  node) as a ``TrainPlan``: ``cost()`` on meta, then one
                  ``step_fn`` on the card under ``FlopCounterMode``: its
                  aten FLOPs equal the prediction's exactly, its launches
                  the meta launches, its peak within 1 % of the predicted;
                  two more steps timed without the counter (TFLOP/s and
                  the share of the f32 peak); (c) of (a)'s decode rows
                  that fit, the one with the largest predicted peak: one
                  ``ServePlan.step_fn`` on the card, peak within 1 % of
                  the row's, launches the row's (the one fitting prefill
                  row, xlstm-125m's, left for phase 34's time).
30. ``shard``     the sharded engine (``repro_torch.engine.shard``): (a) a
                  one-rank NCCL world (``file://`` store in a temporary
                  directory, no network) and its (1, 1) ("data",
                  "model") mesh; ``shard_run_dpps`` at the dense full
                  width (5, 505,956,352), the sparse one (ER(24), K =
                  14) and circulant at (10, 7840), 5 noised rounds, each
                  bit for bit ``run_dpps`` (state and sensitivity rows),
                  ms a round beside the engine's, a round's c10d calls
                  (``CollectiveCount``) equal to ``shard_collectives``,
                  the peak beside six reckoned buffers; ``shard_run_
                  partpsp`` on the paper MLP (N = 10, 3 steps) bit for
                  bit ``run_partpsp``; (b) the row blocks a world of
                  several ranks launches: ``pushsum_mix`` with W (B, N) at
                  the dense full width (B = 1 of 5) and the training
                  shape (B = 1 of 4), ``spmm`` with (B, K) slots at the
                  sparse full width (B = 6 of 24), the perturbation of
                  rows [node0, node0 + B) at both full widths, each bit
                  for bit the rows of the full launch, one block against
                  its plain version, timed beside its bound and library
                  call (``torch.sparse.mm`` where it agrees with the
                  kernel, else ``torch.matmul`` of the dense W rows).
31. ``model_axis`` tensor and expert parallelism for serving
                  (``repro_torch.models.parallel``): (a) llama3.2-1b at
                  full width through ``build_serve_plan(arch, mesh)`` on a
                  one-rank NCCL world's (1, 1) mesh, a 4,096-token
                  prefill and 16 greedy decode steps, logits bit for bit
                  the unsharded plan's, each step's c10d calls
                  (``C10dCount``) equal to ``tp_collectives``; (b) a
                  2-rank gloo world on the one card (``chip_smoke.py
                  --tp-rank JSON`` subprocesses; gloo all-reduces CUDA
                  tensors through the host, NCCL refuses two ranks on one
                  device), mesh (1, 2): llama3.2-1b (4,096-token prefill,
                  16 steps) and llama4-scout at one MoE layer (1,024, 8)
                  at full width, each rank's logits within 1e-4 of the
                  unsharded plan's on the same weights, its greedy tokens
                  equal, the ranks bit-equal, the calls counted, the peak
                  below the unsharded one beside its reckoning, and one
                  ``flash_attention.cu`` launch at its head shard against
                  the plain version; the data seed the first giving every
                  top-1 logit margin above 2e-4 and routing margin above
                  1e-5. Its times are two ranks sharing one card with
                  host-staged all-reduces: no speed figures of tensor
                  parallelism.
32. ``model_axis_train`` PartPSP training over the model axis
                  (``build_train_plan(arch, mesh)``): (a) 29b's TrainPlan
                  (llama3.2-1b, N = 4, 2 x 1,024 tokens a node) unsharded
                  and on a one-rank NCCL world's (1, 1) mesh, 2 steps
                  each: the states bit for bit alike (a digest of every
                  leaf's bits), the first step's c10d calls equal to
                  ``train_collectives``, the launches exact; the strided
                  perturbation (``dpps_perturb.cu`` at a column map) at
                  rank 0's half of llama's shared w_up and at maps whose
                  run, offset and column straddle Philox counters, bit
                  for bit the whole launch's columns and the plain
                  version's, timed beside a contiguous launch; (b) a
                  2-rank gloo world on the card (``chip_smoke.py
                  --train-rank JSON`` subprocesses), M = 2: llama3.2-1b at
                  full width, N = 4, 1 x 256 tokens a node, 2 steps,
                  against the unsharded plan run first in this process on
                  the same weights and Philox bits (losses within 1e-5
                  relative, the parameter leaves within atol 1e-4 at a
                  stride of at most 2^24 elements a leaf, every leaf's L1
                  norm and the sensitivity vectors within 1e-5), each
                  rank's calls, launches (the strided ones apart) and peak
                  below the unsharded one; (c) llama4-scout at one MoE
                  layer, one node's loss and backward at M = 2, its
                  gradient shards against the unsharded ones likewise,
                  every top-1 router margin above 1e-5. Its times are two
                  ranks sharing one card: no speed figures of tensor
                  parallelism.
33. ``model_axis_groups`` the model axis for the xLSTM, Mamba2/Zamba2
                  and cross-attention groups: (a) on a one-rank NCCL
                  world's (1, 1) mesh, xlstm-125m whole (a 512-token
                  prompt), zamba2-7b at one unit and no trailing layers
                  and llama-3.2-vision-11b at one of its 8 units with its
                  1,600 image tokens (1,024 tokens each), 8 greedy decode
                  steps each, logits bit for bit the unsharded plan's,
                  c10d calls equal to ``axis_collectives``; (b) the same
                  three over a 2-rank gloo world on the card
                  (``chip_smoke.py --groups-rank JSON`` subprocesses), M =
                  2: logits within 1e-4 of the unsharded plan's, greedy
                  tokens equal (every top-1 margin above 2e-4), the ranks
                  bit-equal, the calls counted, each rank's peak below the
                  unsharded one, ``flash_attention.cu`` at each rank's
                  head shard (zamba2's shared block, D = 112; the VLM's
                  self layers, D = 128) against the plain version; (c) on
                  the same ranks, PartPSP of the three cut as phase 19
                  cuts them, N = 2, 1 x 128 tokens a node, 2 steps,
                  gamma_n 1/100 of 32b's (``GROUPS_NOISE``), against the
                  unsharded plan run in this process (while the ranks
                  serve) on the same weights and Philox bits at 32b's
                  tolerances, the calls (``C10dCount``), the launches
                  (xlstm's strided perturbations among them) and the
                  peaks; (d) the dry run's rows of
                  the three at ``--model-shards 2`` (prefill_32k and
                  train_4k, on meta, the card hidden): ``ok``, one rank's
                  FLOPs and peak below phase 29's unsharded rows. Its
                  times are two ranks sharing one card: no speed figures
                  of tensor parallelism.
34. ``model_axis_rest`` the rest of the model axis: head counts that M
                  does not divide (a rank's whole heads, ranks without
                  any) and the long_500k decode with each KV cache's
                  slots over "data" (the reference's ``shard_seq``): (a)
                  on a one-rank NCCL world's (1, 1) mesh, gemma3-1b at
                  full width (512-token prompt, 2 greedy steps) and the
                  long_500k decode of gemma3-1b, bit for bit the unsharded
                  plan's; (b) gemma3-1b (H = 4) over 8 gloo ranks on the
                  card (``chip_smoke.py --rest-rank JSON``), mesh (1, 8),
                  ranks 0, 2, 4, 6 without heads: logits within 1e-4 of
                  the unsharded plan's, greedy tokens equal, the ranks
                  bit-equal, the calls counted, each rank's flash
                  launches (26 or none) and one launch at its head share
                  against the plain version; (c) 4 greedy long_500k
                  steps at positions 524,284-524,287 of gemma3-1b whole
                  (27.9 GB of cache) and zamba2-7b at one unit, from a
                  seeded cache drawn by blocks of slots (a rank draws its
                  own), over 2 gloo ranks at (2, 1), teacher-forced by
                  the unsharded run's tokens: logits within 1e-4, tokens
                  equal where the margin is above 2e-4, the data ranks
                  bit-equal, each step's c10d calls (the data ranks'
                  MAX and SUM merge an attention layer), each rank's
                  peak below the unsharded one; (d) the dry run's rows
                  of llama4-scout prefill_32k and gemma3-1b's and
                  zamba2-7b's long_500k on ``--mesh pod16x16`` (started
                  with 29a's): ``ok``, the busiest model rank named. Its
                  times are ranks sharing one card: no speed figures.
35. ``examples``  the six ``examples_torch`` scripts on the card through
                  their ``main(argv)`` (stdout kept apart, its last lines
                  in the record): quickstart, ``partpsp_train.py
                  --full-scale --nodes 4 --steps 2 --chunk 1`` (llama3.2-1b
                  at full width, d_s = 243,286,016; its second step timed
                  alone), decentralized_serve, fault_tolerance,
                  observability and ``privacy_sweep.py --smoke``: each
                  one's seconds, peak, launches (``l1_norm`` and
                  ``dpps_perturb`` on every one, ``pushsum_mix`` on the
                  dense ones) and outcome; ``attention_train`` with flash
                  against without at llama3.2-1b's width (B = 1, S =
                  2,048; atol 1e-5, rtol 1e-4; one flash launch, a
                  comparison kept out of the kernels line); and, last, a
                  probe of the profiler in this long process: 3 sparse
                  rounds (ER(24), d = 300,001) under ``torch.profiler``,
                  the wrappers' launch counts beside the trace's kernels,
                  the state against the plain route on the card.

Each kernel counts its launches. The counts are set to 0 just before each
path (phases 3-7, 10, 13, 15, 17, each run of 19 and 22, each serve of 20,
23, each run of 24, 25 and 26, each battery of 27, a codec each in
its wire battery, each run of 28, each card step of 29, each sharded
run of 30a, each timed run of 31 and 33a-b, a rank's among them, 32a's
and each 32b rank's steps, each 33c rank's steps, each run of 34a-c,
a rank's among them, and each example of 35) and read just
after; each path names the kernels it must launch
(and the sparse paths must launch ``pushsum_mix`` no time; the training
paths exactly their counts). Then come the card's
name and power limit (``nvidia-smi``), the ``kernels`` line with every
kernel's times beside its bound, and the status line. Any
failure raises and exits non-zero. Without a CUDA card, or without the
repository beside it, the script prints nothing on stdout and exits 2.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
PROCESS_T0 = time.perf_counter()

# The card's published peaks (H100 SXM data sheet, dense, no sparsity).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
INT32_OPS_PER_S = 33.5e12  # half the f32 lanes of an SM are int32 lanes
TF32_OPS_PER_S = 495e12    # dense TF32 on the tensor cores

PAPER = dict(n=10, d_s=7840)             # the paper MLP's shared layer l1
FULL = dict(n=5, d_s=505_956_352)        # full-width shared vector, N = 5
# The shared vector PartPSP gossips for xlstm-125m under its own rule
# ("group_0/mlstm/.*" shared, default local), on ER(24, p = 8/24).
SPARSE_FULL = dict(n=24, d_s=95_669_064)
SPARSE_TRAIN_N = 128                     # ER(128, p = 8/128): K = 21
SPARSE_TRAIN = dict(n=SPARSE_TRAIN_N, d_s=PAPER["d_s"])
# The widest point of benchmarks/bench_sparse.py: ER(4096, p = 8/N) at its
# seed (2024, K = 24) and its width d = 8.
SPARSE_SWEEP = dict(n=4096, d=8, seed=2024)
CONSENSUS_ROUNDS, TRAIN_STEPS = 20, 50
SEED = 2024
# Serving: prefill_32k's sequence length (configs/base.py), its batch of 32
# cut to 1 to fit one card; 32 tokens generated.
SERVE_PROMPT, SERVE_GEN = 32_768, 32
# The other group kinds at full width on a prompt of train_4k's length
# (4,096): arch -> the cut of its one group (None: whole). llama4-scout
# keeps 4 of its 48 layers: 8.81 GB a layer in f32 (16 experts of 3 x 5120
# x 8192), 43.5 GB with the embedding and head; all 48 would be 431 GB.
# xlstm-125m keeps 1 of its 3 units: its prefill is a host-bound loop over
# the 4,096 positions a recurrent layer (whole, 11-20 s on an H100 80GB
# HBM3 at 700 W). zamba2-7b's serve left this phase for the script's time
# limit with phase 34 (4 of its 11 units took 12.6 s): it serves at full
# width in phase 18 (one unit, card against CPU), 33 (one unit, over the
# model axis) and 34 (one unit, long_500k decode over "data").
# llama4-maverick (65.9 GB a unit of one dense and one 128-expert layer)
# runs at its smoke config only, in phase 18.
GROUP_SERVE_PROMPT = 4096
GROUP_SERVE = {"llama-3.2-vision-11b": None, "xlstm-125m": dict(n_units=1),
               "llama4-scout-17b-a16e": dict(n_layers=4)}
GROUP_SERVE_SMOKE = ("llama4-scout-17b-a16e", "llama4-maverick-400b-a17b",
                     "xlstm-125m", "zamba2-7b", "llama-3.2-vision-11b")
FLASH_SHAPES = {  # (B, S, H, K, D, window)
    "llama_32k": (1, SERVE_PROMPT, 32, 8, 64, None),
    "gemma3_32k_window512": (1, SERVE_PROMPT, 4, 1, 256, 512),
    "gemma3_32k_global": (1, SERVE_PROMPT, 4, 1, 256, None),
    "ragged_minitron": (2, 1000, 24, 8, 128, None),
    # zamba2-7b's shared attention block at GROUP_SERVE_PROMPT: D = 112
    "zamba2_4k": (1, GROUP_SERVE_PROMPT, 32, 32, 112, None),
    # llama4-scout's (a GQA group of 5) and llama-3.2-vision-11b's self
    # layers at GROUP_SERVE_PROMPT
    "scout_4k": (1, GROUP_SERVE_PROMPT, 40, 8, 128, None),
    "vision_4k": (1, GROUP_SERVE_PROMPT, 32, 8, 128, None),
    # a rank's head shard in phase 31b (M = 2): llama3.2-1b's 16 of 32
    # query heads and 4 of 8 KV heads at 4,096 tokens, llama4-scout's 20
    # and 4 at 1,024
    "llama_4k_rank_of_2": (1, 4096, 16, 4, 64, None),
    "scout_1k_rank_of_2": (1, 1024, 20, 4, 128, None),
    # and in phase 33b: zamba2-7b's shared block (16 of 32 heads, D = 112)
    # and llama-3.2-vision-11b's self layers (16 of 32, 4 of 8 KV heads)
    # at 1,024 tokens
    "zamba2_1k_rank_of_2": (1, 1024, 16, 16, 112, None),
    "vision_1k_rank_of_2": (1, 1024, 16, 4, 128, None),
    # a rank's run of heads at an offset into its first GQA group
    # (FLASH_OFFSETS): llama4-scout's heads [3, 6) reading KV heads 0 and
    # 1 (a group of 5 straddled) at 4,096 tokens; phase 34b's rank of 8
    # holding one of gemma3-1b's 4 heads (its one KV head) at 512
    "scout_4k_heads_3_to_6": (1, GROUP_SERVE_PROMPT, 3, 2, 128, None),
    "gemma3_512_rank_of_8": (1, 512, 1, 1, 256, None),
}
# the shapes above whose query heads start inside a GQA group: (group,
# head0), query head i reading KV head (head0 + i) // group
FLASH_OFFSETS = {"scout_4k_heads_3_to_6": (5, 3),
                 "gemma3_512_rank_of_8": (4, 1)}
# SDPA as the yardstick: is_causal where global, a banded boolean attn_mask
# (S x S, 1 GiB at 32k) where windowed
FLASH_SDPA = ("llama_32k", "gemma3_32k_window512", "gemma3_32k_global",
              "ragged_minitron", "zamba2_4k", "scout_4k", "vision_4k",
              "llama_4k_rank_of_2", "scout_1k_rank_of_2",
              "zamba2_1k_rank_of_2", "vision_1k_rank_of_2",
              "scout_4k_heads_3_to_6", "gemma3_512_rank_of_8")

# pushsum_mix past its template (N > 32): (N, D); N = 4096 at d = 8 is
# bench_sparse.py's dense point, at 128 the same as the kernel path pads it;
# (128, 7936) the paper MLP's shared layer on ER(128) under the default
# dense schedule
MIX_WIDE = ((33, 1 << 20), (64, 1 << 20), (256, 1 << 20), (4096, 8),
            (128, 7936), (4096, 128))
# dpps_perturb.cu's plans held to the same s_noise bits: tables patched
# into ops ({} the default), at the short rows of ROWS_WIDE and at the
# long rows of PERTURB_LONG
PERTURB_PLANS = {
    "default": {},
    "long_512": dict(PERTURB_QUADS_PER_BLOCK=512, PERTURB_SHORT_QUADS=0),
    "short_32_lanes": dict(PERTURB_ROW_LANES=32,
                           PERTURB_SHORT_QUADS=1 << 20),
    "short_8_lanes_t64": dict(PERTURB_ROW_LANES=8, PERTURB_THREADS=64,
                              PERTURB_SHORT_QUADS=1 << 20),
}
PERTURB_LONG = dict(n=24, d_s=(1 << 20) - 3)
# the row kernels past a grid of 65,535 rows: (N, d_s); a ring of 70,000
# nodes (K = 3) for one dpps_step
ROWS_WIDE = ((65_536, 300), (100_003, 300))
RING = dict(n=70_000, d_s=300)
# PartPSP training of llama3.2-1b at full width under its own rule
# (group_0 layers [:4] shared) on a 2-out graph of 4 nodes: N = 8, the
# reference launcher's default, needs about 115 GB and does not fit one
# card. Per-node batch 2 of 1,024 tokens, 5 steps.
TRAIN_LM = dict(arch="llama3.2-1b", n=4, per_node_batch=2, seq_len=1024,
                steps=5, d_s=243_286_016)
TRAIN_FULL = dict(n=TRAIN_LM["n"], d_s=TRAIN_LM["d_s"])
# card against CPU: the same model at full width with 2 layers, 4 nodes,
# one sequence of 64 tokens a node, 3 steps, the noise through bits_at
AGREE_LM = dict(n=4, layers=2, per_node_batch=1, seq_len=64, steps=3)

# PartPSP training of the other group kinds at full width (phase 19): 4 x
# 64 tokens a node (the reference launcher's --per-node-batch 4 --seq-len
# 64), 3 steps, a 2-out graph, the dense schedule, sync every 5. Runs a-c
# train with PartPSP: run -> the arch, N, the cut of its one group (None:
# whole) and d_s under its rules; depth is cut where one card (80 GB)
# forces it, and in run a (xlstm-125m, 1 of its 3 units) where its
# host-bound time loops (12.6-14.5 s a step whole on an H100 80GB HBM3 at
# 700 W) would take the whole script near its time limit. Run d (llama4-scout, one of 48 layers, 17.1 GB of f32
# params) takes one node's loss and backward only: at N = 2 the params
# take 34 GB and the local gradients another 33.7 GB.
GROUP_TRAIN = dict(per_node_batch=4, seq_len=64, steps=3, sync_interval=5)
GROUP_TRAIN_RUNS = {
    "a": dict(arch="xlstm-125m", n=4, cut=dict(n_units=1), d_s=31_889_688),
    "b": dict(arch="zamba2-7b", n=4, cut=dict(n_units=1, trailing_mamba=0),
              d_s=205_528_064),
    "c": dict(arch="llama-3.2-vision-11b", n=2, cut=dict(n_units=1),
              d_s=872_448_000),
    "d": dict(arch="llama4-scout-17b-a16e", n=1, cut=dict(n_layers=1),
              d_s=63_006_720),
}
# phase 20: run b's consensus checkpoint served on a 512-token prompt
CHECKPOINT_SERVE = dict(prompt=512, gen=8)
# phase 21: the five smoke configs, card against CPU. Routing is discrete:
# at this seed of the params and batches every MoE token's top-1 margin
# clears 1e-4 on the CPU in every pass (at SEED one of maverick's sits at
# 2.9e-6, where the card's and the CPU's sums could route it apart).
GROUP_AGREE = dict(n=4, per_node_batch=2, seq_len=16, steps=3, seed=2035)
# phase 22: phase 15's session, 3 steps a driver; the MLP's loop against
# its engine, 5 steps; the paper MLP's layers with bias vectors (784 -> 10
# -> 784 -> 10) as perturbation leaves: the second starts at column 7850
LOOP_STEPS, LOOP_MLP_STEPS = 3, 5
MLP_BIAS_SHAPES = [(784, 10), (10,), (10, 784), (784,), (784, 10), (10,)]
# phase 23: rounds before the save, rounds after the restore; phase 15's
# model cut to its first RESUME_LAYERS layers, the four its rule shares (the
# same d_s and shared leaves; 4 x 505M f32 parameters, an 8.1 GB state in
# place of the whole model's 19.8 GB, whose save and load took 58-65 s on
# an H100 80GB HBM3 at 700 W: cut to keep the script inside its time limit
# with phase 33)
RESUME_SPLIT = (2, 1)
RESUME_LAYERS = 4
# phase 24: the fault models of the consensus and MLP runs, and of training
FAULTS = dict(drop_rate=0.2, straggler_rate=0.1, churn=((4, 5, 12),))
FAULTS_TRAIN = dict(drop_rate=0.2, straggler_rate=0.25)
# phase 25: bounded delays (B = 2) on llama3.2-1b's shared width, N = 4
DELAYS = dict(max_delay=2, timeout_rate=0.1, rates=(1, 2, 1, 1))
ASYNC_ROUNDS = 10
ASYNC_MLP = dict(max_delay=2, timeout_rate=0.1, rates=(1, 2, 1, 1) * 32)

KERNELS = {
    "l1_norm_rows": dict(source="src/repro_torch/kernels/csrc/l1_norm.cu",
                         replaces="src/repro/kernels/l1_clip.py:32"),
    "dpps_perturb_rows": dict(
        source="src/repro_torch/kernels/csrc/dpps_perturb.cu",
        replaces="src/repro/kernels/dpps_perturb.py:49"),
    "pushsum_mix": dict(source="src/repro_torch/kernels/csrc/pushsum_mix.cu",
                        replaces="src/repro/kernels/pushsum_mix.py:38"),
    "spmm": dict(source="src/repro_torch/kernels/csrc/spmm.cu",
                 replaces="src/repro/kernels/spmm.py:52"),
    "clip_scale_rows": dict(source="src/repro_torch/kernels/csrc/clip_scale.cu",
                            replaces="src/repro/kernels/l1_clip.py:50"),
    "laplace_from_bits": dict(
        source="src/repro_torch/kernels/csrc/laplace_noise.cu",
        replaces="src/repro/kernels/laplace_noise.py:40"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:91"),
    # dpps_perturb.cu launched for a noise norm only (an audit mechanism's
    # row): counted apart, reported in dpps_perturb_rows' entry
    "noise_l1_rows": dict(
        source="src/repro_torch/kernels/csrc/dpps_perturb.cu",
        replaces="src/repro/kernels/dpps_perturb.py:49"),
}
DENSE_PATH = ("l1_norm_rows", "dpps_perturb_rows", "pushsum_mix")
SPARSE_PATH = ("l1_norm_rows", "dpps_perturb_rows", "spmm")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound(nbytes: float, f32_ops: float = 0.0, int_ops: float = 0.0,
          tf32_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (f32_ops / F32_OPS_PER_S + int_ops / INT32_OPS_PER_S
             + tf32_ops / TF32_OPS_PER_S)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def demangled(name: str) -> str:
    """``ns::fn<1, 2>`` from an Itanium-mangled ``_ZN2ns2fnILi1ELi2EE...``
    (nested names and integer or bool template arguments only)."""
    parts, i = [], 3 if name.startswith("_ZN") else 0
    while i < len(name) and name[i].isdigit():
        j = i
        while name[j].isdigit():
            j += 1
        parts.append(name[j:j + int(name[i:j])])
        i = j + int(name[i:j])
    args = re.findall(r"L[ib](\d+)E", name[i:]) if name[i:i + 1] == "I" else []
    return "::".join(parts) + (f"<{', '.join(args)}>" if args else "")


def ptxas_summary(log: str, kernel: str) -> list:
    """Registers, spilled bytes and static shared memory of each entry
    function whose (mangled) name holds ``kernel``, from ``-Xptxas -v``'s
    report (empty where the library was cached)."""
    entries, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = (dict(function=demangled(m.group(1)))
                   if kernel in m.group(1) else None)
            if cur is not None:
                entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem_bytes"] = int(m.group(1))
    return entries


def ptxas_brief(entries: list) -> dict:
    """Registers of each instantiation and the spilled bytes of all."""
    return dict(instantiations=len(entries),
                spill_bytes=sum(e.get("spill_stores", 0) + e.get("spill_loads", 0)
                                for e in entries),
                registers={e["function"]: e.get("registers") for e in entries})


def cuda_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def d_pad_of(d_s: int) -> int:
    return -(-d_s // 128) * 128


def require_launches(launches: dict, expected, where: str,
                     absent=()) -> None:
    """Every kernel in ``expected`` ran on this path; none in ``absent``."""
    missing = [k for k in expected if launches[k] <= 0]
    require(not missing, f"{missing} did not run on the {where} path: "
                         f"{launches}")
    extra = [k for k in absent if launches[k] != 0]
    require(not extra, f"{extra} ran on the {where} path: {launches}")


def timed_windows(torch, plain, check, d: int, cols: int) -> float:
    """Run ``plain(c0, c1)`` over column windows of [0, d) and hand each
    result to ``check(c0, c1, result)``; returns the summed device
    milliseconds of the ``plain`` calls alone, by CUDA events. Used where
    a plain version's temporaries would not fit beside full-width buffers:
    its time is then the same work in pieces."""
    events = []
    for c0 in range(0, d, cols):
        c1 = min(d, c0 + cols)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        result = plain(c0, c1)
        ev1.record()
        events.append((ev0, ev1))
        check(c0, c1, result)
        del result
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events)


def compare(got, want, rtol: float, atol: float, cols: int = 1 << 24):
    """(max abs error, all |got - want| <= atol + rtol |want|), taken over
    column windows so no full-size temporary is made."""
    err, ok = 0.0, True
    for c0 in range(0, got.shape[-1], cols):
        g, w = got[..., c0:c0 + cols], want[..., c0:c0 + cols]
        d = (g - w).abs()
        err = max(err, d.max().item())
        ok = ok and bool((d <= atol + rtol * w.abs()).all())
    return err, ok


# -- phase 2: each kernel against its plain version --------------------------

def host_us(torch, fn, calls: int = 1000) -> float:
    """Host µs a call of ``fn()``: a host clock around ``calls`` calls with no
    synchronise in between (one synchronise after), over ``calls``. Taken
    before any profiler runs in the process: a profiled process launches
    more slowly afterwards."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_us(torch, fn, calls: int = 200) -> tuple:
    """(device µs a call, kernels a call) of ``fn()``: the kernel time
    ``torch.profiler`` records over ``calls`` calls (None where it records
    none), over ``calls``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    busy, count = 0.0, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            busy += us
            count += e.count
    return (busy / calls if busy > 0 else None), count / calls


def small_shape_calls(torch, ops, dev) -> dict:
    """{(shape, kernel): (wrapper call, yardstick call, yardstick name)}
    for the norm at the paper and sparse-train shapes, the mix and the
    perturbation at the paper shape (the sparse paths mix through
    ``spmm``), on seeded inputs: the calls whose host and device µs the
    kernels line gives, the yardstick's under ``library_*`` (one PyTorch
    call of the same function) or ``copy_*`` (the perturbation's copy)."""
    calls = {}
    for name, shape in (("paper", PAPER), ("sparse_train", SPARSE_TRAIN)):
        n, d_s = shape["n"], shape["d_s"]
        gen = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn((n, d_pad_of(d_s)), generator=gen, device=dev)
        calls[name, "l1_norm_rows"] = (
            lambda x=x, d_s=d_s: ops.l1_norm_rows(x, d_s),
            lambda x=x, d_s=d_s: torch.linalg.vector_norm(x[:, :d_s], 1,
                                                          dim=1), "library")
        if name == "paper":
            w = torch.full((n, n), 1.0 / n, device=dev)
            calls[name, "pushsum_mix"] = (
                lambda x=x, w=w: ops.pushsum_mix(w, x),
                lambda x=x, w=w: torch.matmul(w, x), "library")
            eps, o = torch.randn_like(x), torch.empty_like(x)
            scale = torch.tensor(0.7, device=dev)
            calls[name, "dpps_perturb_rows"] = (
                lambda x=x, eps=eps, d_s=d_s: ops.dpps_perturb_rows(
                    x, eps, scale, 0.1, d_s, seed=SEED, t=1),
                lambda x=x, eps=eps, o=o: torch.add(x, eps, out=o), "copy")
    return calls


def check_kernels(torch, ops, ref, shape: dict, dev, iters: int,
                  cols: int, mix: bool = True) -> dict:
    """The dense path's kernels vs plain at one shape (``pushsum_mix`` only
    with ``mix``); returns per-kernel errors and times.

    The pad columns of the inputs hold 1e4, not 0: the norms must leave
    them out and the perturbed rows must come out 0 there, so a wrong mask
    or a wrong row offset (past 2^31 elements at full width) shows. Where
    the plain version's temporaries would not fit beside the full-width
    buffers (its Philox draw holds a dozen int64 copies of the row), it
    runs over column windows of ``cols``; its time is then the sum of the
    windows' times, the same work in pieces.
    """
    n, d_s = shape["n"], shape["d_s"]
    d_pad = d_pad_of(d_s)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s = torch.randn((n, d_pad), generator=gen, device=dev)
    eps = torch.randn((n, d_pad), generator=gen, device=dev).mul_(0.1)
    s[:, d_s:] = 1e4
    eps[:, d_s:] = 1e4
    scale_v, gamma_n, t = 0.7, 0.1, 3
    scale = torch.tensor(scale_v, device=dev)
    out = {}

    # l1_norm_rows: the plain version fits (one |x| temporary)
    # rtol 1e-5: per-block partials against PyTorch's reduction order
    got = ops.l1_norm_rows(eps, d_s)
    err, ok = compare(got, ref.l1_norm_rows(eps, d_s), rtol=1e-5, atol=0.0)
    require(ok, f"l1_norm_rows disagrees at {shape}: max abs err {err}")
    require(torch.equal(ops.l1_norm_rows(eps, d_s), got),
            f"l1_norm_rows gives other bits on a second launch at {shape}")
    out["l1_norm_rows"] = dict(
        max_abs_err=err, plan=ops.l1_plan(n, d_s),
        ms=cuda_ms(torch, lambda: ops.l1_norm_rows(eps, d_s), iters),
        plain_ms=cuda_ms(torch, lambda: ref.l1_norm_rows(eps, d_s),
                         max(1, iters // 2)),
        library_ms=cuda_ms(torch, lambda: torch.linalg.vector_norm(
            eps[:, :d_s], 1, dim=1), max(1, iters // 2)),
        bound=bound(4.0 * n * d_s + 4 * n, f32_ops=2.0 * n * d_s))

    # dpps_perturb_rows, Philox variant (the main path's)
    k_out, k_eps, k_noise = ops.dpps_perturb_rows(s, eps, scale, gamma_n, d_s,
                                                  seed=SEED, t=t)
    require(bool((k_out[:, d_s:] == 0).all()), "pad lanes not zero")
    err = 0.0
    eps_l1 = torch.zeros(n, device=dev, dtype=torch.float64)
    noise_l1 = torch.zeros_like(eps_l1)
    events = []

    def window_bits(c0, c1):
        return ref.philox_bits(SEED, t, n, c0, c1, device=dev).to(torch.uint32)

    w0 = min(d_s, cols)  # warm-up: the plain version's first launches
    ref.dpps_perturb_rows(s[:, :w0], eps[:, :w0], scale, gamma_n, w0,
                          bits=window_bits(0, w0))
    for c0 in range(0, d_s, cols):
        c1 = min(d_s, c0 + cols)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()  # the plain version's time includes its Philox draw
        p_out, p_eps, p_noise = ref.dpps_perturb_rows(
            s[:, c0:c1], eps[:, c0:c1], scale, gamma_n, c1 - c0,
            bits=window_bits(c0, c1))
        ev1.record()
        events.append((ev0, ev1))
        diff = (k_out[:, c0:c1] - p_out).abs()
        err = max(err, diff.max().item())
        # rtol 1e-6 / atol 1e-6: the card's logf may differ by an ulp
        require(bool((diff <= 1e-6 + 1e-6 * p_out.abs()).all()),
                f"dpps_perturb_rows disagrees at {shape}, cols [{c0}, {c1})")
        eps_l1 += p_eps.double()
        noise_l1 += p_noise.double()
        del p_out, diff
    torch.cuda.synchronize()
    plain_ms = sum(a.elapsed_time(b) for a, b in events)
    for name, k, p in (("eps_l1", k_eps, eps_l1), ("noise_l1", k_noise,
                                                    noise_l1)):
        rel = ((k.double() - p) / p).abs().max().item()
        require(rel < 1e-5, f"dpps_perturb_rows {name} off by {rel} at {shape}")
    # Laplace(0, scale) has E|x| = scale: the row's noise L1 over d_s
    mean_abs = (k_noise.double() / d_s / scale_v).tolist()
    tol = 6.0 / math.sqrt(d_s) + 1e-4
    require(all(abs(m - 1.0) < tol for m in mean_abs),
            f"Philox noise mean|x|/scale {mean_abs} not within {tol} of 1")
    ms = cuda_ms(torch, lambda: ops.dpps_perturb_rows(
        s, eps, scale, gamma_n, d_s, seed=SEED, t=t), iters)
    # per element: Philox4x32-10 is 10 rounds of 2 mul-hi, 2 mul, 4 xor and
    # 2 key adds over 4 elements (25 int32 ops); the transform, the two
    # adds and the two norms about 17 f32 operations
    out["dpps_perturb_rows"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        copy_ms=copy_ms(torch, s, eps, iters),
        plan=ops.perturb_plan(n, d_pad), noise_mean_abs_over_scale=mean_abs,
        bound=perturb_bound(n, d_s, d_pad))
    del k_out
    if not mix:
        return out

    # pushsum_mix: W of the d-Out graph; the plain version fits
    w = torch.zeros((n, n), device=dev)
    for i in range(n):
        for k in range(2):
            w[(i + k) % n, i] += 0.5
    got = ops.pushsum_mix(w, s)
    want = ref.pushsum_mix(w, s)
    # rtol 1e-5 / atol 1e-6: fma in j order against cuBLAS's order
    err, ok = compare(got, want, rtol=1e-5, atol=1e-6)
    require(ok, f"pushsum_mix disagrees at {shape}: max abs err {err}")
    del want
    require(torch.equal(ops.pushsum_mix(w, s), got),
            f"pushsum_mix gives other bits on a second launch at {shape}")
    del got
    out["pushsum_mix"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: ops.pushsum_mix(w, s), iters),
        plain_ms=cuda_ms(torch, lambda: ref.pushsum_mix(w, s),
                         max(1, iters // 2)),
        library_ms=cuda_ms(torch, lambda: torch.matmul(w, s),
                           max(1, iters // 2)),
        bound=bound(8.0 * n * d_pad + 4 * n * n, f32_ops=2.0 * n * n * d_pad))
    return out


def perturb_bound(n: int, d_s: int, d_pad: int):
    """The perturbation's bound: s and eps read, s_noise written (pad
    columns too), the norms; 25 int32 and 17 f32 operations an element."""
    return bound(8.0 * n * d_s + 4.0 * n * d_pad + 8 * n + 4,
                 f32_ops=17.0 * n * d_s, int_ops=25.0 * n * d_s)


def copy_ms(torch, s, eps, iters: int) -> float:
    """The copy yardstick of the perturbation: ``torch.add(s, eps, out=o)``
    reads and writes the same bytes (no noise, no norms)."""
    o = torch.empty_like(s)
    ms = cuda_ms(torch, lambda: torch.add(s, eps, out=o), iters)
    del o
    return ms


def csr_of(torch, topo, dev):
    """Round 0's padded CSR of ``topo`` on the card, its dense W, and the
    number of real edges (nonzero weights)."""
    idx, vals = topo.sparse_weights(0)
    nnz = int((vals > 0).sum())
    return (torch.as_tensor(idx, device=dev),
            torch.as_tensor(vals, dtype=torch.float32, device=dev),
            topo.weight_matrix_torch(0, device=dev), nnz)


def check_spmm(torch, ops, ref, topo, d: int, dev, iters: int,
               cols: int) -> dict:
    """``spmm`` against its plain version (over column windows of ``cols``:
    its per-slot (N, cols) temporaries would not fit at full width), and
    :func:`library_spmm` of W as the library yardstick, at x (N, d)."""
    n = topo.n_nodes
    idx, vals, w, nnz = csr_of(torch, topo, dev)
    k = idx.shape[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + n)
    x = torch.randn((n, d), generator=gen, device=dev)
    got = ops.spmm(idx, vals, x)
    err = [0.0]

    def check(c0, c1, want):
        # rtol 1e-6 / atol 1e-6: fma against a separate multiply and add
        e, ok = compare(got[:, c0:c1], want, rtol=1e-6, atol=1e-6)
        require(ok, f"spmm disagrees at N={n}, d={d}, cols [{c0}, {c1}): "
                    f"max abs err {e}")
        err[0] = max(err[0], e)

    ref.spmm(idx, vals, x[:, :min(d, cols)])  # warm-up
    plain_ms = timed_windows(
        torch, lambda c0, c1: ref.spmm(idx, vals, x[:, c0:c1]), check, d,
        cols)
    bit_exact = bool(torch.equal(got, ops.pushsum_mix(w, x)))
    require(bit_exact, f"spmm differs from pushsum_mix at N={n}, d={d}")
    library = library_spmm(torch, w, x, got, max(1, iters // 2))
    del got
    plan = ops.spmm_plan(n, k, d, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    out = dict(n=n, d=d, k=k, edges=nnz, plan=plan, max_abs_err=err[0],
               equals_pushsum_mix=bit_exact,
               ms=cuda_ms(torch, lambda: ops.spmm(idx, vals, x), iters),
               plain_ms=plain_ms, **library,
               bound=bound(8.0 * n * d + 8.0 * n * k,
                           f32_ops=2.0 * nnz * d))
    del x
    torch.cuda.empty_cache()
    return out


def library_spmm(torch, w, x, want, iters: int) -> dict:
    """The library yardstick of ``spmm`` for the dense W rows ``w``
    against x: ``torch.sparse.mm`` of their CSR (one cuSPARSE call) where
    its result agrees with the kernel's (rtol 1e-5 / atol 1e-6, the mix's
    tolerance), else ``torch.matmul(w, x)`` (one cuBLAS call), held to the
    same tolerance. cuSPARSE gave wrong values where the dense operand
    passed 2^31 elements: its time and error stay beside the yardstick as
    ``sparse_mm_ms`` / ``sparse_mm_max_abs_err``."""
    w_csr = w.to_sparse_csr()
    err, ok = compare(torch.sparse.mm(w_csr, x), want, rtol=1e-5, atol=1e-6)
    sparse_ms = cuda_ms(torch, lambda: torch.sparse.mm(w_csr, x), iters)
    out = dict(sparse_mm_ms=sparse_ms, sparse_mm_max_abs_err=err,
               sparse_mm_agrees=ok)
    if ok:
        return dict(out, library="torch.sparse.mm", library_ms=sparse_ms,
                    library_max_abs_err=err)
    err, ok = compare(torch.matmul(w, x), want, rtol=1e-5, atol=1e-6)
    require(ok, f"spmm: torch.matmul of W disagrees with the kernel: {err}")
    return dict(out, library="torch.matmul", library_max_abs_err=err,
                library_ms=cuda_ms(torch, lambda: torch.matmul(w, x), iters))


def philox_statistics(torch, ops, dev) -> dict:
    """The Philox variant's noise alone (s = eps = 0, gamma_n = 1)."""
    n, d_s = PAPER["n"], PAPER["d_s"]
    zeros = torch.zeros((n, d_pad_of(d_s)), device=dev)
    noise = ops.dpps_perturb_rows(zeros, zeros, 2.0, 1.0, d_s, seed=SEED,
                                  t=0)[0]
    body = noise[:, :d_s].double() / 2.0
    stats = dict(mean_over_scale=body.mean().item(),
                 mean_abs_over_scale=body.abs().mean().item(),
                 frac_abs_above_scale=(body.abs() > 1).double().mean().item(),
                 pad_lanes_zero=bool((noise[:, d_s:] == 0).all()))
    m = n * d_s
    require(abs(stats["mean_over_scale"]) < 6 * math.sqrt(2.0 / m),
            f"noise mean {stats}")
    require(abs(stats["mean_abs_over_scale"] - 1) < 6 / math.sqrt(m),
            f"noise mean |x| {stats}")
    require(abs(stats["frac_abs_above_scale"] - math.exp(-1)) < 0.01,
            f"noise tail {stats}")
    require(stats["pad_lanes_zero"], "pad lanes of the noise not zero")
    return stats


# -- phases 3 and 5: consensus at full width ---------------------------------

def consensus(torch, api, T, ops, dev, *, topo, shape: dict, schedule: str,
              phase: str, expected, absent=(), constants=None,
              default_schedule: bool = False) -> dict:
    """``Session.run(CONSENSUS_ROUNDS)`` over an (N, d_s) f32 buffer, as a
    user calls it: one call, timed on the host around it, with the launch
    counts read over it. The consensus error by round comes from a second,
    untimed pass of one round a call (each call packs the state anew), whose
    last state must agree with the timed run's. (C', lambda) are calibrated
    unless ``constants`` gives them; with ``default_schedule`` the session
    picks its own schedule, which must be ``schedule``."""
    from repro_torch.core.pushsum import consensus_error

    n, d_s = shape["n"], shape["d_s"]
    t0 = time.perf_counter()
    c_prime, lam = constants or T.calibrate_constants(topo)
    calib_s = time.perf_counter() - t0
    b = 1.0
    # The Remark-1 recursion stays bounded only for
    # gamma_n < (1/lam - 1) * b / (2 C' d_s); take half of that.
    gamma_max = (1.0 / lam - 1.0) * b / (2.0 * c_prime * d_s)
    gamma_n = 0.5 * gamma_max
    session = api.Session.build(topo, privacy=api.PrivacySpec(
        b=b, gamma_n=gamma_n, c_prime=c_prime, lam=lam),
        schedule=None if default_schedule else schedule, seed=SEED)
    require(session.plan.use_kernels and session.device.type == "cuda",
            "the session did not pick the card and its kernels")
    require(session.plan.schedule == schedule, "schedule")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    values = {"shared": torch.randn((n, d_s), generator=gen, device=dev)}
    err0 = consensus_error(values["shared"], chunk=1 << 24).item()

    # the errors by round (this pass also warms the allocator)
    state, errors = None, []
    for r in range(CONSENSUS_ROUNDS):
        state = (session.run(1, values=values) if state is None
                 else session.run(1, state=state)).state
        errors.append(consensus_error(state.push.s["shared"], a=state.push.a,
                                      chunk=1 << 24).item())
    del state

    # the timed run: every round in one call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = session.run(CONSENSUS_ROUNDS, values=values)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    state = rep.state
    a_mean = state.push.a.double().mean().item()
    finite = all(bool(torch.isfinite(x).all()) for x in
                 (state.push.s["shared"], state.push.a, state.sens.s_local))
    require(finite, f"{phase} state not finite")
    require(abs(a_mean - 1.0) < 1e-6, f"mean(a) = {a_mean}, not 1")
    require_launches(launches, expected, phase, absent)
    require(state.t == CONSENSUS_ROUNDS, "round counter")
    err_last = consensus_error(state.push.s["shared"], a=state.push.a,
                               chunk=1 << 24).item()
    # the same seeded rounds in one call or in twenty: the same state
    require(abs(err_last - errors[-1]) <= 1e-6 * abs(errors[-1]),
            f"{phase}: one call ends at error {err_last}, one round a call "
            f"at {errors[-1]}")
    k = (None if session.plan.sparse_idx is None
         else int(session.plan.sparse_idx.shape[-1]))
    del state, rep
    per_round, per_run = round_breakdown(torch, ops, session.plan, values,
                                         d_s, gamma_n)
    return dict(phase=phase, n=n, d_s=d_s, d_pad=d_pad_of(d_s),
                topology=type(topo).__name__, schedule=schedule, csr_k=k,
                sync_interval=session.cfg.sync_interval,
                rounds=CONSENSUS_ROUNDS, c_prime=c_prime, lam=lam,
                calibrate_s=calib_s, b=b, gamma_n=gamma_n,
                gamma_n_stability_limit=gamma_max, run_ms=run_ms,
                ms_per_round=run_ms / CONSENSUS_ROUNDS,
                consensus_error_initial=err0,
                consensus_error_by_round=errors,
                consensus_error_final_one_call=err_last, a_mean=a_mean,
                launches=launches, peak_mem_gb=peak_gb,
                round_breakdown_ms=per_round,
                round_breakdown_sum_ms=sum(per_round.values()),
                per_run_ms=per_run)


def round_breakdown(torch, ops, plan, values: dict, d_s: int,
                    gamma_n: float) -> tuple[dict, dict]:
    """Device milliseconds of the pieces of a run, each timed alone on
    buffers of the round's shape: per round, the three kernels; per
    ``Session.run`` call, the packing of the state at its segment boundary
    (a copy when d_s is no multiple of 128) and the zero perturbation of a
    consensus run. What the measured run takes beyond them is host work
    and the (N,) bookkeeping."""
    from repro_torch.core.packing import LANE, PackedLayout

    layout = PackedLayout.from_tree(values, lane=LANE)
    buf = layout.pack(values)
    # the perturb reads s and eps from separate buffers, as in the round:
    # one buffer passed twice would be read from device memory once
    eps = torch.zeros_like(buf)
    scale = torch.tensor(1.0, device=buf.device)
    mix = plan.mix_at(1)
    if plan.schedule == "sparse":
        mix_fn = lambda: ops.spmm(mix["sparse_idx"], mix["sparse_vals"], buf)
    else:
        mix_fn = lambda: ops.pushsum_mix(mix["w"], buf)
    per_round = dict(
        l1_norm_rows=cuda_ms(torch, lambda: ops.l1_norm_rows(buf, d_s), 3),
        dpps_perturb_rows=cuda_ms(torch, lambda: ops.dpps_perturb_rows(
            buf, eps, scale, gamma_n, d_s, seed=SEED, t=1), 3),
        mix=cuda_ms(torch, mix_fn, 3))
    per_run = dict(
        pack=cuda_ms(torch, lambda: layout.pack(values), 3),
        zero_perturbation=cuda_ms(torch, lambda: torch.zeros_like(buf), 3))
    del buf, eps
    torch.cuda.empty_cache()
    return per_round, per_run


# -- phases 4 and 6: PartPSP training ----------------------------------------

def training_batches(mlp, data, torch, n: int, steps: int) -> list:
    """Seeded per-node batches of 32, drawn on the CPU so that every device
    sees the same ones."""
    task = data.SyntheticClassification(d_in=mlp.D_IN, seed=SEED,
                                        device="cpu")
    skew = data.dirichlet_partition(n, mlp.N_CLASSES, seed=SEED)
    return [task.node_batches(torch.Generator().manual_seed(SEED + 1 + t),
                              n, 32, skew) for t in range(steps)]


def training_setup(api, mlp, torch, device, *, topo, schedule: str,
                   batches: list, c_prime=None, lam=None):
    """The paper MLP setup of benchmarks/common.py build_setup, with the
    noise rate cut to 1e-5: its default 0.005 lies outside the recursion's
    stability region at the calibrated constants, where the reference's
    losses turn to NaN as well. (C', lambda) are calibrated unless given."""
    params = mlp.init_mlp(torch.Generator().manual_seed(SEED))
    session = api.Session.build(
        topo, privacy=api.PrivacySpec(b=1.0, gamma_n=1e-5, c_prime=c_prime,
                                      lam=lam),
        model=mlp.mlp_loss, params=params, partition=mlp.PARTITIONS[
            "partpsp-1"], algorithm="partpsp", gamma_l=0.1, gamma_s=0.1,
        clip=100.0, schedule=schedule, sync_interval=5, seed=SEED,
        device=device)
    on_device = [tuple(x.to(session.device) for x in b) for b in batches]
    return session, (lambda t: on_device[t])


def training(torch, api, mlp, ops, *, topo, schedule: str, batches: list,
             phase: str, expected, absent=()) -> tuple[dict, object]:
    t0 = time.perf_counter()
    session, batch_at = training_setup(api, mlp, torch, None, topo=topo,
                                       schedule=schedule, batches=batches)
    build_s = time.perf_counter() - t0  # mostly the (C', lambda) calibration
    require(session.plan.use_kernels, f"{phase} did not pick the kernels")
    require(session.plan.schedule == schedule, "schedule")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = session.train(TRAIN_STEPS, batch_at)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    loss = rep.trajectory["loss_mean"]
    require_launches(launches, expected, phase, absent)
    require(all(math.isfinite(float(x)) for x in loss),
            f"{phase} loss not finite")
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    require(last < first, f"{phase} loss did not fall: {first} -> {last}")
    return dict(phase=phase, n=topo.n_nodes, topology=type(topo).__name__,
                schedule=schedule, d_s=session.partition.d_shared(),
                steps=TRAIN_STEPS, gamma_n=session.cfg.gamma_n,
                c_prime=session.cfg.c_prime, lam=session.cfg.lam,
                session_build_s=build_s, loss_first10=first,
                loss_last10=last, ms_per_step=wall / TRAIN_STEPS * 1e3,
                compile_s=rep.compile_s, launches=launches), (session, rep)


# -- phase 7: the tree ops (L1 clip, Laplace noise) at full width -------------

def tree_ops(torch, ops, ref, dev) -> tuple[dict, dict]:
    """``ops.l1_clip_tree`` and ``ops.laplace_noise_tree`` on the sparse
    full-width tree (N = 24, d_s = 95,669,064), each against its plain
    version on the card; then each kernel's time alone."""
    n, d_s = SPARSE_FULL["n"], SPARSE_FULL["d_s"]
    d_pad = d_pad_of(d_s)
    m = n * d_s
    cols = 1 << 24
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    # rows at scales 0.5 .. 1.5: a clip at the median norm scales about
    # half of them and leaves the others
    x = torch.randn((n, d_pad), generator=gen, device=dev)
    x[:, d_s:] = 0
    x *= torch.linspace(0.5, 1.5, n, device=dev)[:, None]
    plain_norms = ref.l1_norm_rows(x, d_s)
    clip = plain_norms.median().item()
    # Philox bits of (SEED, round 0) for every element, built in windows
    bits = torch.empty((n, d_s), dtype=torch.uint32, device=dev)
    for c0 in range(0, d_s, 1 << 21):
        c1 = min(d_s, c0 + (1 << 21))
        bits[:, c0:c1] = ref.philox_bits(SEED, 0, n, c0, c1,
                                         device=dev).to(torch.uint32)
    scale_v = 0.7
    scale = torch.tensor(scale_v, device=dev)
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    clipped, norms = ops.l1_clip_tree({"shared": x[:, :d_s]}, clip)
    noise = ops.laplace_noise_tree({"shared": bits}, scale)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    require_launches(launches, ("l1_norm_rows", "clip_scale_rows",
                                "laplace_from_bits"), "tree-ops",
                     absent=("dpps_perturb_rows", "pushsum_mix", "spmm"))

    # -- the clip against its plain version
    clipped, noise = clipped["shared"], noise["shared"]
    rel = ((norms - plain_norms).abs() / plain_norms).max().item()
    require(rel < 1e-5, f"l1_clip_tree norms off by {rel}")
    denom = torch.clamp_min(norms / clip, 1.0)
    n_scaled = int((denom > 1).sum())
    require(0 < n_scaled < n, f"{n_scaled} of {n} rows scaled")
    err = [0.0]

    def check_clip(c0, c1, want):
        # rtol 1e-6: the same correctly rounded division; expect 0
        e, ok = compare(clipped[:, c0:c1], want, rtol=1e-6, atol=0.0)
        require(ok, f"clip_scale_rows disagrees at cols [{c0}, {c1})")
        err[0] = max(err[0], e)

    clip_plain_ms = timed_windows(
        torch, lambda c0, c1: ref.clip_scale_rows(x[:, c0:c1], c1 - c0, denom),
        check_clip, d_s, cols)
    clip_err = err[0]
    del clipped

    # -- the noise against its plain version, and its statistics
    err[0] = 0.0
    sums = torch.zeros(2, dtype=torch.float64, device=dev)

    def check_noise(c0, c1, want):
        # rtol 1e-6: the card's logf may differ from the plain log by an ulp
        e, ok = compare(noise[:, c0:c1], want, rtol=1e-6, atol=0.0)
        require(ok, f"laplace_from_bits disagrees at cols [{c0}, {c1})")
        err[0] = max(err[0], e)
        body = noise[:, c0:c1].abs() / scale_v
        sums[0] += body.double().sum()
        sums[1] += (body > 1).double().sum()

    noise_plain_ms = timed_windows(
        torch, lambda c0, c1: ref.laplace_from_bits(bits[:, c0:c1], scale),
        check_noise, d_s, cols)
    mean_abs, frac_above = (sums / m).tolist()
    require(abs(mean_abs - 1.0) < 6.0 / math.sqrt(m) + 1e-4,
            f"Laplace mean|x|/scale = {mean_abs}")
    p = math.exp(-1)
    require(abs(frac_above - p) < 6.0 * math.sqrt(p * (1 - p) / m) + 1e-4,
            f"Laplace P(|x| > scale) = {frac_above}")
    pad = ops.laplace_from_bits(
        torch.full((64,), 1 << 31, dtype=torch.int64, device=dev).to(
            torch.uint32), scale)
    pad_zero = bool((pad == 0).all())
    require(pad_zero, "bits 1 << 31 do not give exactly 0")
    noise_err = err[0]
    del noise

    flat_bits = bits.reshape(-1)
    results = {
        "clip_scale_rows": dict(
            max_abs_err=clip_err,
            ms=cuda_ms(torch, lambda: ops.clip_scale_rows(x, d_s, denom), 5),
            plain_ms=clip_plain_ms,
            library_ms=cuda_ms(torch, lambda: x / denom[:, None], 3),
            bound=bound(8.0 * n * d_pad + 4 * n, f32_ops=1.0 * n * d_s)),
        # about 25 f32 operations an element: the transform and logf
        "laplace_from_bits": dict(
            max_abs_err=noise_err,
            ms=cuda_ms(torch, lambda: ops.laplace_from_bits(flat_bits, scale),
                       5),
            plain_ms=noise_plain_ms, library_ms=None,
            bound=bound(8.0 * m + 4, f32_ops=25.0 * m)),
    }
    del x, bits, flat_bits
    torch.cuda.empty_cache()
    return dict(phase="tree_ops", n=n, d_s=d_s, d_pad=d_pad, clip=clip,
                rows_scaled=n_scaled, norms_max_rel_err=rel,
                laplace=dict(scale=scale_v, elements=m,
                             mean_abs_over_scale=mean_abs,
                             frac_abs_above_scale=frac_above,
                             expected_frac=p, pad_bits_give_zero=pad_zero),
                launches=launches), results


# -- phase 8: the card against the CPU ---------------------------------------

def agreement(torch, api, T, mlp, trained: dict) -> dict:
    """Seeded runs on the card (kernels) and on the CPU (plain versions)
    draw the same Philox bits, so they agree to rounding: rtol 1e-5 plus
    1e-6 of the largest magnitude for consensus, whose near-zero entries
    are differences of much larger mixed terms; 1e-3 for the training
    losses, through which 50 steps of tanh gradients pass the last-ulp
    differences on. ``trained`` maps a name to (topology, schedule,
    batches, card session, card report) of a training phase; the CPU run
    takes the card session's calibrated (C', lambda)."""
    d_s = PAPER["d_s"]
    out = {}
    for name, topo, schedule in (
            ("dense", T.DOutGraph(PAPER["n"], 2), "dense"),
            ("sparse", sparse_graph(SPARSE_FULL["n"]), "sparse")):
        n = topo.n_nodes
        vals = torch.randn((n, d_s),
                           generator=torch.Generator().manual_seed(1))
        states = {}
        for device in ("cuda", "cpu"):
            session = api.Session.build(
                topo, privacy=api.PrivacySpec(b=1.0, gamma_n=1e-6),
                schedule=schedule, sync_interval=5, chunk=3, seed=SEED,
                device=device)
            require(session.plan.use_kernels == (device == "cuda"),
                    "routing")
            rep = session.run(7, values={"x": vals})
            states[device] = rep.state.push.s["x"].cpu()
        want = states["cpu"]
        err = (states["cuda"] - want).abs().max().item()
        lim = 1e-6 * want.abs().max().item()
        require(torch.allclose(states["cuda"], want, rtol=1e-5, atol=lim),
                f"{name} consensus on the card differs from the CPU by {err}")
        out[f"{name}_consensus_n{n}_max_abs_err"] = err
    for name, (topo, schedule, batches, card, card_rep) in trained.items():
        session, batch_at = training_setup(
            api, mlp, torch, "cpu", topo=topo, schedule=schedule,
            batches=batches, c_prime=card.cfg.c_prime, lam=card.cfg.lam)
        cpu_loss = session.train(TRAIN_STEPS,
                                 batch_at).trajectory["loss_mean"]
        gpu_loss = card_rep.trajectory["loss_mean"]
        rel = float(abs(gpu_loss - cpu_loss).max() / abs(cpu_loss).max())
        require(rel < 1e-3,
                f"{name} training loss on the card vs CPU: rel diff {rel}")
        out[f"{name}_training_n{topo.n_nodes}_loss_max_rel_diff"] = rel
    return dict(phase="agreement", **out)


# -- phase 9: flash attention against its plain version ----------------------

def check_flash(torch, F, ops, ref, name: str, dev, iters: int) -> dict:
    """``ops.flash_attention_bshd`` against ``ref.flash_attention`` at one
    shape. The plain version's (B, H, rows, keys) scores do not fit at 32k,
    so it runs over windows of query rows: rows [r0, r1) against keys
    [0, r1), positions offset by ``q_start = r0``; every row is checked.
    Tolerance atol 1e-5 / rtol 1e-4 on outputs of magnitude about 1: the
    online softmax sums in another order than the plain one and expf may
    differ from the plain exp by an ulp. A shape of FLASH_OFFSETS is a
    rank's run of heads at that offset (query head i reads KV head (head0
    + i) // group)."""
    b, s, h, kh, d, window = FLASH_SHAPES[name]
    group, head0 = FLASH_OFFSETS.get(name, (h // kh, 0))
    gen = torch.Generator(device=dev).manual_seed(SEED + s + d)
    q = torch.randn((b, s, h, d), generator=gen, device=dev)
    k = torch.randn((b, s, kh, d), generator=gen, device=dev)
    v = torch.randn((b, s, kh, d), generator=gen, device=dev)
    launch = lambda: ops.flash_attention_bshd(q, k, v, window=window,
                                              group=group, head0=head0)
    got = launch()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, heads, S, D)
    rows = max(16, min(s, (1 << 29) // (b * h * s)))
    errs = dict(abs=0.0, rel=0.0)

    def plain(r0, r1):
        return ref.flash_attention(qt[:, :, r0:r1], kt[:, :, :r1],
                                   vt[:, :, :r1], group=group,
                                   window=window, q_start=r0, head0=head0)

    def check(r0, r1, want):
        g = got[:, r0:r1].transpose(1, 2)
        diff = (g - want).abs()
        require(bool((diff <= 1e-5 + 1e-4 * want.abs()).all()),
                f"flash_attention disagrees at {name}, rows [{r0}, {r1}): "
                f"max abs err {diff.max().item()}")
        errs["abs"] = max(errs["abs"], diff.max().item())
        big = want.abs() >= 1e-3  # relative error where it means something
        if bool(big.any()):
            errs["rel"] = max(errs["rel"],
                              (diff[big] / want.abs()[big]).max().item())

    plain(0, min(s, rows))  # warm-up
    plain_ms = timed_windows(torch, plain, check, s, rows)
    ms = cuda_ms(torch, launch, iters, warmup=1)
    library_ms = sdpa_err = None
    if name in FLASH_SDPA:
        # the yardstick: one PyTorch call, KV heads repeated to the query
        # heads that read them (the memory-efficient backend takes f32,
        # is_causal and a mask); a window as a banded boolean (S, S) mask
        reads = (head0 + torch.arange(h, device=dev)) // group
        kr = kt.index_select(1, reads)
        vr = vt.index_select(1, reads)
        band = None
        if window is not None:
            pos = torch.arange(s, device=dev)
            band = (pos[:, None] >= pos[None, :]) & (
                pos[:, None] - pos[None, :] < window)
        sdpa = lambda: F.scaled_dot_product_attention(
            qt, kr, vr, attn_mask=band, is_causal=band is None)
        sdpa_err = (sdpa().transpose(1, 2) - got).abs().max().item()
        library_ms = cuda_ms(torch, sdpa, iters, warmup=1)
        del kr, vr, band
    pairs = ops.visible_pairs(s, -1 if window is None else window) * b * h
    nbytes = 4.0 * (2 * b * s * h * d + 2 * b * s * kh * d)
    # 4 D flops a visible pair and head, each as three TF32 products
    out = dict(shape=dict(b=b, s=s, h=h, kh=kh, d=d, window=window,
                          group=group, head0=head0),
               geometry=ops.flash_geometry(b, s, h, d),
               rows_per_plain_window=rows, max_abs_err=errs["abs"],
               max_rel_err=errs["rel"], ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, sdpa_max_abs_diff=sdpa_err,
               bound=bound(nbytes, tf32_ops=3 * 4.0 * d * pairs),
               f32_core_bound_ms=bound(nbytes, f32_ops=4.0 * d * pairs)[0])
    out["pct_of_bound"] = 100.0 * out["bound"][0] / ms
    del q, k, v, got, qt, kt, vt
    torch.cuda.empty_cache()
    return out


# -- phases 10 and 17: serving at full width ----------------------------------

def attention_layers(cfg) -> int:
    """Attention applications in one forward pass of ``cfg``: one flash
    launch each in a flash prefill. An MoE group's every layer (dense or
    MoE) has one, a Zamba unit one (its shared block), a cross/self unit
    one for each self layer; cross layers and xLSTM have none."""
    n = 0
    for g in cfg.groups:
        if g.kind in ("attn", "moe"):
            n += g.n_layers
        elif g.kind == "zamba":
            n += g.n_units
        elif g.kind == "cross_self":
            n += g.n_units * g.self_per_unit
    return n


def bracketed(torch, module, names, events: dict, length: int | None = None):
    """Replace ``module.<name>`` for each of ``names`` by a wrapper that
    records CUDA events around each call into ``events[name]``, with the
    call's ``window`` keyword. With ``length``, only the calls whose last
    argument has ``length`` positions on its second axis (a recurrent
    scan's inputs are (B, S, ...): the prefill's, not a decode step's) are
    recorded; the others run as they are. Returns the function that puts
    the originals back."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            if length is not None and args[-1].shape[1] != length:
                return fn(*args, **kwargs)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args, **kwargs)
            e1.record()
            events.setdefault(name, []).append((e0, e1, kwargs.get("window")))
            return out
        return timed

    for n, fn in saved.items():
        setattr(module, n, wrap(n, fn))

    def restore():
        for n, fn in saved.items():
            setattr(module, n, fn)
    return restore


def serve(torch, ops, dev, arch: str, *, prompt: int = SERVE_PROMPT,
          cut: dict | None = None) -> dict:
    """``Session.build(model=...).serve`` of ``arch`` at its full published
    width, f32, ``flash_prefill`` on: one ``prompt``-token prompt,
    ``SERVE_GEN`` tokens; all layers, or its one group cut as ``cut``
    says (e.g. ``n_layers``, ``n_units``). A VLM gets image embeddings (normal x 0.1, its n_image_tokens)
    and its gates at 0.5. Each flash launch of the prefill, and each
    recurrent scan (``ssm._mlstm_scan``, ``_slstm_scan``, ``_mamba2_scan``),
    is bracketed by CUDA events (the functions themselves are called as
    the model calls them), for their shares of the prefill. Requires
    exactly one flash launch an attention application and no other
    kernel, finite logits, tokens in range, every cache leaf finite and
    every KV cache at prompt + gen slots."""
    import dataclasses

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_flatten_with_path, tree_leaves
    from repro_torch.models import ssm
    from repro_torch.models.attention import open_cross_gates
    from repro_torch.models.transformer import Transformer

    spec = get_config(arch)
    cfg = dataclasses.replace(spec.model, flash_prefill=True)
    if cut is not None:
        (group,) = cfg.groups
        cfg = dataclasses.replace(cfg, groups=(
            dataclasses.replace(group, **cut),))
    model = Transformer(cfg)
    n_attn = attention_layers(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    # on the card: the port's default device
    params = open_cross_gates(model.init(gen))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree_leaves(params))
    session = Session.build(model=model, seed=SEED)
    require(session.device.type == "cuda", "serve session not on the card")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, prompt),
                                     generator=gen, device=dev)}
    enc = None
    if spec.family == "vlm":
        enc = torch.randn((1, cfg.groups[0].n_image_tokens, cfg.d_model),
                          generator=gen, device=dev) * 0.1
        batch["image_embeds"] = enc

    events = {}
    loops = ("_mlstm_scan", "_slstm_scan", "_mamba2_scan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    restore = [bracketed(torch, ops, ("flash_attention_bshd",), events),
               bracketed(torch, ssm, loops, events, length=prompt)]
    try:
        rep = session.serve(params, batch, gen=SERVE_GEN, enc=enc)
    finally:
        for r in restore:
            r()
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(launches["flash_attention"] == n_attn,
            f"{arch}: {launches['flash_attention']} flash launches for "
            f"{n_attn} attention layers")
    require_launches(launches, ("flash_attention",) if n_attn else (),
                     f"{arch} serve",
                     absent=tuple(k for k in KERNELS if k != "flash_attention"))
    logits = rep.logits
    require(tuple(logits.shape) == (1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all()), f"{arch}: logits")
    toks = rep.tokens
    require(tuple(toks.shape) == (1, SERVE_GEN)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"{arch}: tokens {toks.tolist()}")
    leaves = dict(tree_flatten_with_path(rep.cache)[0])
    shapes = {p: tuple(x.shape) for p, x in leaves.items()}
    kv = {p: sh for p, sh in shapes.items()
          if p.rsplit("/", 1)[-1] in ("k", "v")}
    require(all(sh[-3] == prompt + SERVE_GEN for sh in kv.values())
            and bool(kv) == (n_attn > 0), f"{arch}: cache slots {shapes}")
    require(all(bool(torch.isfinite(x).all()) for x in leaves.values()),
            f"{arch}: cache not finite")
    decode = decode_profile(torch, model, params, rep, prompt, enc)
    flash = events.get("flash_attention_bshd", [])
    flash_ms = [a.elapsed_time(b) for a, b, _ in flash]
    windowed = [w is not None and w >= 0 for _, _, w in flash]
    loop_ms = {name: sum(a.elapsed_time(b) for a, b, _ in events[name])
               for name in loops if name in events}
    prefill_ms = rep.prefill_s * 1e3
    out = dict(phase="serve", arch=arch, layers=cfg.total_layers,
               attention_layers=n_attn, params=n_params, d_model=cfg.d_model,
               heads=cfg.n_heads, kv_heads=cfg.n_kv_heads,
               head_dim=cfg.head_dim, batch=1, prompt=prompt,
               image_tokens=None if enc is None else enc.shape[1],
               gen=SERVE_GEN, init_s=init_s, prefill_s=rep.prefill_s,
               prompt_tokens_per_s=prompt / rep.prefill_s,
               decode_s=rep.decode_s, decode_ms_per_token=rep.ms_per_token,
               decode_device_busy_ms_per_step=decode["busy_ms"],
               decode_device_idle_share=(
                   None if decode["busy_ms"] is None
                   else 1.0 - decode["busy_ms"] / rep.ms_per_token),
               decode_top_kernels=decode["top"],
               flash_ms_total=sum(flash_ms),
               flash_ms_global=sum(m for m, w in zip(flash_ms, windowed)
                                   if not w),
               flash_ms_windowed=sum(m for m, w in zip(flash_ms, windowed)
                                     if w),
               flash_launches_windowed=sum(windowed),
               flash_share_of_prefill=sum(flash_ms) / prefill_ms,
               recurrent_loop_ms=loop_ms,
               recurrent_loop_share_of_prefill=sum(loop_ms.values())
               / prefill_ms,
               peak_mem_gb=peak_gb, cache_shape=shapes,
               tokens=toks[0].tolist(), launches=launches)
    del params, rep, logits, batch, enc
    torch.cuda.empty_cache()
    return out


def decode_profile(torch, model, params, rep, prompt: int, enc=None,
                   steps: int = 3) -> dict:
    """Device time of a decode step by kernel, from ``torch.profiler``:
    ``steps`` steps at the cache's last free slot. ``busy_ms`` is the
    summed kernel time a step (None if the profiler saw no device time);
    against the served ms per token it gives the device's idle share in
    decode. ``top``: the five kernels with the most time, ms a step."""
    from torch.profiler import ProfilerActivity, profile

    pos = prompt + SERVE_GEN - 1
    last = rep.tokens[:, -1]
    with torch.no_grad():
        model.decode_step(params, rep.cache, last, pos, enc)  # warm-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                model.decode_step(params, rep.cache, last, pos, enc)
            torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append((us / 1e3 / steps, e.count / steps, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(busy_ms=busy if busy > 0 else None,
                top=[dict(kernel=k[:80], ms_per_step=ms, calls_per_step=n)
                     for ms, n, k in rows[:5]])


# -- phase 11: serving, the card against the CPU ------------------------------

def serve_agreement(torch, ops, dev) -> dict:
    """llama3.2-1b at full width, 2 layers, flash_prefill, B = 2, a 384-token
    prompt (ragged against the kernel's 64-row tiles only in that it needs
    none), 8 tokens: the card (kernel) and the CPU (plain) with the same
    parameters and the same Gumbel noise give prefill logits within
    rtol 1e-4 / atol 1e-4 (f32 matmuls and softmax in other orders) and the
    same tokens. Then flash against plain prefill on the card at B = 4,
    S = 2,048, same tolerance."""
    import dataclasses

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_map
    from repro_torch.engine.rounds import gumbel
    from repro_torch.models.config import AttnGroup
    from repro_torch.models.transformer import Transformer

    cfg = dataclasses.replace(get_config("llama3.2-1b").model,
                              flash_prefill=True,
                              groups=(AttnGroup(n_layers=2),))
    model = Transformer(cfg)
    cpu_gen = torch.Generator().manual_seed(SEED)
    params = model.init(cpu_gen, device="cpu")
    b, s, gen_len = 2, 384, 8
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=cpu_gen)
    noise = gumbel(cpu_gen, (gen_len - 1, b, cfg.vocab_size), "cpu")
    out, launches = {}, None
    for device in ("cuda", "cpu"):
        p = tree_map(lambda x: x.to(device), params)
        noise_d = noise.to(device)
        ops.reset_launch_counts()
        out[device] = Session.build(model=model, device=device).serve(
            p, {"tokens": tokens.to(device)}, gen=gen_len,
            noise_at=lambda t: noise_d[t])
        if device == "cuda":
            launches = ops.launch_counts()
    require(launches["flash_attention"] == 2, f"agreement launches {launches}")
    card, cpu = out["cuda"], out["cpu"]
    err = (card.logits.cpu() - cpu.logits).abs().max().item()
    require(torch.allclose(card.logits.cpu(), cpu.logits, rtol=1e-4,
                           atol=1e-4), f"serve logits card vs CPU: {err}")
    same = bool(torch.equal(card.tokens.cpu(), cpu.tokens))
    require(same, f"serve tokens card {card.tokens.tolist()} vs CPU "
                  f"{cpu.tokens.tolist()}")

    # flash against plain prefill on the card, B = 4, S = 2,048
    p = tree_map(lambda x: x.to(dev), params)
    toks = torch.randint(0, cfg.vocab_size, (4, 2048), generator=cpu_gen).to(dev)
    plain = Transformer(dataclasses.replace(cfg, flash_prefill=False))
    with torch.no_grad():
        lf, cf = model.prefill(p, {"tokens": toks})
        lp, cp = plain.prefill(p, {"tokens": toks})
    err2 = (lf - lp).abs().max().item()
    require(torch.allclose(lf, lp, rtol=1e-4, atol=1e-4),
            f"flash vs plain prefill logits on the card: {err2}")
    # layer 0's K/V come before any attention: equal; layer 1's within
    # the logits' tolerance
    kf, kp = cf["group_0"]["k"], cp["group_0"]["k"]
    require(torch.equal(kf[0], kp[0]) and torch.allclose(
        kf, kp, rtol=1e-4, atol=1e-4), "flash and plain prefill caches differ")
    del p, lf, lp, cf, cp, kf, kp
    torch.cuda.empty_cache()
    return dict(phase="serve_agreement", layers=2, batch=b, prompt=s,
                gen=gen_len, logits_max_abs_err=err, tokens_equal=same,
                tokens=card.tokens.tolist(), flash_launches=launches[
                    "flash_attention"],
                flash_vs_plain_b4_s2048_logits_max_abs_err=err2)


# -- phase 12: pushsum_mix past its template ---------------------------------

def mix_wide(torch, ops, ref, dev) -> dict:
    """``pushsum_mix`` at N > 32 (its tiled kernel) against its plain
    version, with ``torch.matmul`` timed beside it, at :data:`MIX_WIDE`,
    and every tile of ``ops.MIX_TILES`` at each shape giving the default
    plan's bits; then its fma chain bit for bit against the template
    kernel's at N = 32 (a 33-node W whose last row and column are zero,
    first 32 rows) and against ``spmm`` on ER(64)'s and ER(4096)'s CSR.
    Tolerance rtol 1e-5 / atol 1e-6: fma in j order against cuBLAS's
    order."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = ops.mix_plan
    out = {}
    for n, d in MIX_WIDE:
        gen = torch.Generator(device=dev).manual_seed(SEED + n)
        x = torch.randn((n, d), generator=gen, device=dev)
        w = torch.rand((n, n), generator=gen, device=dev)
        w /= w.sum(0, keepdim=True)
        got = ops.pushsum_mix(w, x)
        err, ok = compare(got, ref.pushsum_mix(w, x), rtol=1e-5, atol=1e-6)
        require(ok, f"pushsum_mix disagrees at N={n}, D={d}: max abs err "
                    f"{err}")
        require(torch.equal(ops.pushsum_mix(w, x), got),
                f"pushsum_mix gives other bits on a second launch at N={n}")
        for tile in ops.MIX_TILES:
            ops.mix_plan = lambda n_, d_, sms_, tile=tile, **kw: plan(
                n_, d_, sms_, tile, **kw)
            try:
                same = torch.equal(ops.pushsum_mix(w, x), got)
            finally:
                ops.mix_plan = plan
            require(same, f"pushsum_mix tile {tile} gives other bits at "
                          f"N={n}, D={d}")
        iters = 20 if n * d > 1 << 22 else 200
        out[f"n{n}_d{d}"] = dict(
            n=n, d=d, plan=plan(n, d, sms), max_abs_err=err,
            every_tile_same_bits=True,
            ms=cuda_ms(torch, lambda: ops.pushsum_mix(w, x), iters),
            plain_ms=cuda_ms(torch, lambda: ref.pushsum_mix(w, x), iters // 2),
            library_ms=cuda_ms(torch, lambda: torch.matmul(w, x), iters // 2),
            bound=bound(8.0 * n * d + 4.0 * n * n, f32_ops=2.0 * n * n * d))
        del x, w, got
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((33, 1 << 20), generator=gen, device=dev)
    w32 = torch.rand((32, 32), generator=gen, device=dev)
    w32 /= w32.sum(0, keepdim=True)
    w33 = torch.zeros((33, 33), device=dev)
    w33[:32, :32] = w32
    wide = ops.pushsum_mix(w33, x)
    equals_template = bool(torch.equal(
        wide[:32], ops.pushsum_mix(w32, x[:32].contiguous())))
    require(equals_template, "the tiled mix differs from the template at N=32")
    equals_spmm = {}
    for name, topo, d in (("er64", sparse_graph(64), 1 << 20),
                          ("er4096_d8", sparse_graph(
                              SPARSE_SWEEP["n"], SPARSE_SWEEP["seed"]),
                           SPARSE_SWEEP["d"]),
                          ("er4096_d128", sparse_graph(
                              SPARSE_SWEEP["n"], SPARSE_SWEEP["seed"]), 128)):
        idx, vals, w, _ = csr_of(torch, topo, dev)
        x = torch.randn((topo.n_nodes, d), generator=gen, device=dev)
        equals_spmm[name] = bool(torch.equal(ops.spmm(idx, vals, x),
                                             ops.pushsum_mix(w, x)))
        require(equals_spmm[name], f"pushsum_mix differs from spmm on {name}")
    del x, wide
    torch.cuda.empty_cache()
    return dict(phase="mix_wide", results=out,
                tiled_equals_template_at_32=equals_template,
                equals_spmm=equals_spmm)


# -- phase 13: the default dense schedule on ER(4096) -------------------------

def dense_er4096(torch, api, T, ops, dev) -> dict:
    """bench_sparse.py's widest dense point as a user runs it:
    ``Session.build(ErdosRenyiGraph(4096, p=8/4096, seed=2024))`` with the
    schedule left to its default (dense: every round mixes through
    ``pushsum_mix``'s tiled kernel at (4096, 128)), ``run(20)`` at d_s = 8;
    then the same graph on the sparse schedule. The recursion's constants
    are bench_sparse.py's (C' 0.8, lambda 0.6): the calibration's pairwise
    sweep is O(N^2) a round on the host."""
    from repro_torch.core.dpps import is_sync_round
    from repro_torch.net import ErdosRenyiGraph

    n, d = SPARSE_SWEEP["n"], SPARSE_SWEEP["d"]
    topo = ErdosRenyiGraph(n, p=8.0 / n, seed=SPARSE_SWEEP["seed"])
    shape = dict(n=n, d_s=d)
    plan = ops.mix_plan(n, d_pad_of(d), torch.cuda.get_device_properties(
        dev).multi_processor_count)
    require(plan["kernel"] != "template", f"mix plan {plan}")
    dense = consensus(torch, api, T, ops, dev, topo=topo, shape=shape,
                      schedule="dense", phase="dense_er4096",
                      expected=DENSE_PATH, absent=("spmm",),
                      constants=(0.8, 0.6), default_schedule=True)
    mixes = sum(not is_sync_round(t, dense["sync_interval"])
                for t in range(CONSENSUS_ROUNDS))
    require(dense["launches"]["pushsum_mix"] == mixes,
            f"pushsum_mix launched {dense['launches']['pushsum_mix']} times "
            f"in {CONSENSUS_ROUNDS} rounds with {mixes} mixes")
    sparse = consensus(torch, api, T, ops, dev, topo=topo, shape=shape,
                       schedule="sparse", phase="sparse_er4096",
                       expected=SPARSE_PATH, absent=("pushsum_mix",),
                       constants=(0.8, 0.6))
    return dict(dense, mix_plan=plan, mixes=mixes, sparse_schedule=sparse,
                dense_over_sparse=dense["ms_per_round"]
                / sparse["ms_per_round"])


# -- phase 14: the row kernels past 65,535 rows ------------------------------

def perturb_plans_agree(torch, ops, s, eps, scale, d_s: int, want) -> list:
    """``dpps_perturb_rows`` (Philox) under each of :data:`PERTURB_PLANS`:
    s_noise bit for bit ``want``'s (the default plan's), the norms within
    rtol 1e-5 of it. Returns the plans' names."""
    for name, tables in PERTURB_PLANS.items():
        saved = {k: getattr(ops, k) for k in tables}
        for k, v in tables.items():
            setattr(ops, k, v)
        try:
            got = ops.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=SEED,
                                        t=3)
        finally:
            for k, v in saved.items():
                setattr(ops, k, v)
        require(torch.equal(got[0], want[0]),
                f"dpps_perturb_rows plan {name} gives other bits at "
                f"{tuple(s.shape)}")
        for g, w in zip(got[1:], want[1:]):
            require(compare(g, w, rtol=1e-5, atol=0.0)[1],
                    f"dpps_perturb_rows plan {name} norms at {tuple(s.shape)}")
        del got
    return list(PERTURB_PLANS)


def rows_wide(torch, ops, ref, dev) -> dict:
    """``l1_norm_rows``, ``dpps_perturb_rows`` (Philox) and
    ``clip_scale_rows`` at :data:`ROWS_WIDE`, each against its plain
    version (1e4 in the pad lanes), as in phase 2, the perturbation's
    s_noise the same bits under every plan there and at the long rows of
    :data:`PERTURB_LONG`; then one ``dpps_step`` on the sparse schedule
    over a ring of 70,000 nodes (K = 3), the kernels against the plain
    path on the card from the same state and Philox bits: state rtol 1e-5
    plus 1e-6 of its largest magnitude."""
    from repro_torch.core.dpps import DPPSConfig, dpps_init, dpps_step
    from repro_torch.core.packing import PackedLayout

    out = {}
    for n, d_s in ROWS_WIDE:
        d_pad = d_pad_of(d_s)
        gen = torch.Generator(device=dev).manual_seed(SEED + n)
        s = torch.randn((n, d_pad), generator=gen, device=dev)
        eps = torch.randn((n, d_pad), generator=gen, device=dev).mul_(0.1)
        s[:, d_s:] = 1e4
        eps[:, d_s:] = 1e4
        scale = torch.tensor(0.7, device=dev)
        norms = ops.l1_norm_rows(eps, d_s)
        err_l1, ok = compare(norms, ref.l1_norm_rows(eps, d_s), rtol=1e-5,
                             atol=0.0)
        require(ok, f"l1_norm_rows disagrees at N={n}: {err_l1}")
        k_out = ops.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=SEED, t=3)
        p_out = ref.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=SEED, t=3)
        err_p, ok = compare(k_out[0], p_out[0], rtol=1e-6, atol=1e-6)
        require(ok and bool((k_out[0][:, d_s:] == 0).all()),
                f"dpps_perturb_rows disagrees at N={n}: {err_p}")
        for k, p in zip(k_out[1:], p_out[1:]):
            require(compare(k, p, rtol=1e-5, atol=0.0)[1],
                    f"dpps_perturb_rows norms disagree at N={n}")
        plans = perturb_plans_agree(torch, ops, s, eps, scale, d_s, k_out)
        denom = torch.clamp_min(norms / norms.median(), 1.0)
        clipped = ops.clip_scale_rows(s, d_s, denom)
        require(torch.equal(clipped, ref.clip_scale_rows(s, d_s, denom)),
                f"clip_scale_rows disagrees at N={n}")
        del k_out, p_out, clipped
        out[f"n{n}_d{d_s}"] = {
            "l1_norm_rows": dict(
                max_abs_err=err_l1,
                ms=cuda_ms(torch, lambda: ops.l1_norm_rows(eps, d_s), 50),
                plain_ms=cuda_ms(torch, lambda: ref.l1_norm_rows(eps, d_s),
                                 20),
                library_ms=cuda_ms(torch, lambda: torch.linalg.vector_norm(
                    eps[:, :d_s], 1, dim=1), 20),
                bound=bound(4.0 * n * d_s + 4 * n, f32_ops=2.0 * n * d_s)),
            "dpps_perturb_rows": dict(
                max_abs_err=err_p, plan=ops.perturb_plan(n, d_pad),
                plans_same_bits=plans,
                ms=cuda_ms(torch, lambda: ops.dpps_perturb_rows(
                    s, eps, scale, 0.1, d_s, seed=SEED, t=3), 50),
                plain_ms=cuda_ms(torch, lambda: ref.dpps_perturb_rows(
                    s, eps, scale, 0.1, d_s, seed=SEED, t=3), 5),
                library_ms=None, copy_ms=copy_ms(torch, s, eps, 50),
                bound=perturb_bound(n, d_s, d_pad)),
            "clip_scale_rows": dict(
                max_abs_err=0.0,
                ms=cuda_ms(torch, lambda: ops.clip_scale_rows(s, d_s, denom),
                           50),
                plain_ms=cuda_ms(torch, lambda: ref.clip_scale_rows(
                    s, d_s, denom), 20),
                library_ms=cuda_ms(torch, lambda: s / denom[:, None], 20),
                bound=bound(8.0 * n * d_pad + 4 * n, f32_ops=1.0 * n * d_s)),
        }
        del s, eps
    # the long rows: every plan, s_noise bit for bit
    n, d_s = PERTURB_LONG["n"], PERTURB_LONG["d_s"]
    gen = torch.Generator(device=dev).manual_seed(SEED + n)
    s = torch.randn((n, d_pad_of(d_s)), generator=gen, device=dev)
    eps = torch.randn_like(s)
    scale = torch.tensor(0.7, device=dev)
    want = ops.dpps_perturb_rows(s, eps, scale, 0.1, d_s, seed=SEED, t=3)
    long_plans = perturb_plans_agree(torch, ops, s, eps, scale, d_s, want)
    del s, eps, want
    # one round on a ring of RING["n"] nodes
    n, d_s = RING["n"], RING["d_s"]
    i = torch.arange(n, device=dev)
    idx = torch.sort(torch.stack([(i - 1) % n, i, (i + 1) % n], dim=1),
                     dim=1).values.to(torch.int32)
    vals = torch.full((n, 3), 1.0 / 3.0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((n, d_s), generator=gen, device=dev)
    eps = 0.01 * torch.randn((n, d_s), generator=gen, device=dev)
    ring = {}
    for kernels in (True, False):
        cfg = DPPSConfig(b=1.0, gamma_n=1e-4, schedule="sparse",
                         use_kernels=kernels)
        layout = PackedLayout.from_tree({"x": x}, lane=128 if kernels else 1)
        state = dpps_init({"x": x}, cfg)
        state = state._replace(push=state.push._replace(
            s=layout.pack(state.push.s)))
        ops.reset_launch_counts()
        new, diag = dpps_step(state, {"x": eps}, cfg, layout, sparse_idx=idx,
                              sparse_vals=vals, seed=SEED)
        ring[kernels] = (layout.unpack(new.push.s)["x"], new.push.a,
                         diag["sensitivity_used"], ops.launch_counts())
    got, want = ring[True][0], ring[False][0]
    lim = 1e-6 * want.abs().max().item()
    err = (got - want).abs().max().item()
    require(torch.allclose(got, want, rtol=1e-5, atol=lim),
            f"ring dpps_step: kernels against plain {err}")
    require(torch.equal(ring[True][1], ring[False][1]), "ring: a differs")
    require(abs(ring[True][2].item() - ring[False][2].item())
            <= 1e-5 * abs(ring[False][2].item()), "ring: sensitivity differs")
    counts = ring[True][3]
    require(counts["l1_norm_rows"] == 2 and counts["dpps_perturb_rows"] == 1
            and counts["spmm"] == 1 and counts["pushsum_mix"] == 0,
            f"ring dpps_step launches {counts}")
    del ring, got, want, x, eps
    torch.cuda.empty_cache()
    return dict(phase="rows_wide", results=out,
                perturb_long_rows=dict(PERTURB_LONG,
                                       plans_same_bits=long_plans),
                ring=dict(RING, k=3, max_abs_err=err, launches=counts))


# -- phase 15: PartPSP training of llama3.2-1b at full width ------------------

def stability_gamma_n(T, topo, d_s: int, b: float = 1.0) -> tuple:
    """(C', lambda, the Remark-1 recursion's stability limit on gamma_n,
    half of it): the recursion stays bounded only for gamma_n < (1/lambda -
    1) b / (2 C' d_s)."""
    c_prime, lam = T.calibrate_constants(topo)
    limit = (1.0 / lam - 1.0) * b / (2.0 * c_prime * d_s)
    return c_prime, lam, limit, 0.5 * limit


def shared_dim(torch, model, rules, n: int) -> int:
    """d_s of ``model`` under the partition ``rules`` on ``n`` nodes, from
    its parameter shapes alone (an init on the meta device)."""
    from repro_torch.core.partition import Partition
    from repro_torch.core.tree_utils import tree_map

    meta = model.init(torch.Generator(), device="meta")
    stacked = tree_map(lambda x: x[None].expand((n,) + tuple(x.shape)), meta)
    return Partition.from_rules(stacked, tuple(rules),
                                default="local").d_shared()


def lm_flops(cfg, tokens: int, seq: int) -> float:
    """Matmul flops of one forward of ``cfg`` over ``tokens`` tokens in
    sequences of ``seq``: the projections, the MLP, the LM head, and the
    einsum attention's two products over the full S x S scores (the plain
    route masks, it does not skip)."""
    d, hd, kd = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    mlp = (3 if cfg.activation in ("silu", "geglu") else 2) * d * cfg.d_ff
    per_layer = 2.0 * tokens * (2 * d * hd + 2 * d * kd + mlp) \
        + 4.0 * tokens * seq * hd
    return cfg.total_layers * per_layer + 2.0 * tokens * d * cfg.vocab_size


def training_launches(steps: int, sync_interval: int) -> dict:
    """The exact launches of ``steps`` PartPSP rounds with noise on the
    dense schedule: a norm and a perturbation a round (round 0 also takes
    the norm of s for the recursion's start) and a mix a round that is not
    a sync round; no other kernel."""
    from repro_torch.core.dpps import is_sync_round

    expected = {k: 0 for k in KERNELS}
    expected.update(l1_norm_rows=steps + 1, dpps_perturb_rows=steps,
                    pushsum_mix=sum(not is_sync_round(t, sync_interval)
                                    for t in range(steps)))
    return expected


def transformer_training(torch, ops, T, dev) -> dict:
    """The main path of training: ``Session.build(DOutGraph(4, 2),
    model=Transformer(llama3.2-1b), partition=its shared_rules,
    schedule="dense", algorithm="partpsp")`` on the card at full width (16
    layers, d_model 2048, vocab 128,256: d_s = 243,286,016), then
    ``Session.train(5, batch_at)`` on batches of ``NodeShardedLoader(
    SyntheticLMStream(...))`` (made before the run; their time is given
    apart). The host time of each step comes from a synchronise at its
    start (in ``batch_at``); CUDA events bracket its two gradient passes
    and its DPPS round; the last step runs under ``torch.profiler`` (its
    kernels by device time), so the steady step is the mean of steps 1 to
    3. gamma_n is half the Remark-1 recursion's stability limit at this
    d_s, so the five rounds stay finite."""
    from repro_torch.api import PrivacySpec, Session
    from repro_torch.configs import get_config
    from repro_torch.core import partpsp
    from repro_torch.core.tree_utils import tree_leaves
    from repro_torch.data import NodeShardedLoader, SyntheticLMStream
    from repro_torch.models.transformer import Transformer

    arch = get_config(TRAIN_LM["arch"])
    cfg = arch.model
    n, steps = TRAIN_LM["n"], TRAIN_LM["steps"]
    pnb, seq = TRAIN_LM["per_node_batch"], TRAIN_LM["seq_len"]
    topo = T.DOutGraph(n, 2)
    model = Transformer(cfg)
    d_s = shared_dim(torch, model, arch.shared_rules, n)
    require(d_s == TRAIN_LM["d_s"], f"d_s {d_s}")
    c_prime, lam, limit, gamma_n = stability_gamma_n(T, topo, d_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    session = Session.build(
        topo, privacy=PrivacySpec(b=1.0, gamma_n=gamma_n, c_prime=c_prime,
                                  lam=lam),
        model=model, partition=arch.shared_rules, algorithm="partpsp",
        gamma_l=0.05, gamma_s=0.05, clip=100.0, schedule="dense",
        sync_interval=5, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(session.plan.use_kernels and session.device.type == "cuda"
            and session.plan.schedule == "dense",
            "the training session did not pick the card, its kernels and the "
            "dense schedule")
    require(session.partition.d_shared() == d_s, "session d_s")
    n_params = sum(x[0].numel() for x in tree_leaves(session.init_params))

    t0 = time.perf_counter()
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=seq,
                               n_nodes=n, seed=SEED)
    loader = NodeShardedLoader(stream, per_node_batch=pnb, seed=SEED)
    batches = [loader.batch_at(t) for t in range(steps)]
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    require(tuple(batches[0]["tokens"].shape) == (n, pnb, seq), "batch shape")

    events = {}

    from torch.profiler import ProfilerActivity, profile

    starts = []
    prof = profile(activities=[ProfilerActivity.CUDA])

    def batch_at(t):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        if t == steps - 1:  # the last step runs under the profiler
            prof.start()
        return batches[t]

    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    restore = bracketed(torch, partpsp, ("_grads", "dpps_step"), events)
    try:
        rep = session.train(steps, batch_at)
        torch.cuda.synchronize()
    finally:
        restore()
    starts.append(time.perf_counter())
    prof.stop()
    launches = ops.launch_counts()
    kernel_ms = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            kernel_ms.append((us / 1e3, e.count, e.key))
    kernel_ms.sort(reverse=True)
    busy_ms = sum(k[0] for k in kernel_ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    loss = [float(x) for x in rep.trajectory["loss_mean"]]
    require(all(math.isfinite(x) for x in loss), f"losses {loss}")
    state = rep.state
    a_mean = state.dpps.push.a.double().mean().item()
    require(abs(a_mean - 1.0) < 1e-5, f"mean(a) = {a_mean}")
    require(all(bool(torch.isfinite(x).all()) for x in
                tree_leaves(state.dpps.push.s) + list(state.local)),
            "trained state not finite")
    expected = training_launches(steps, 5)
    require(launches == expected, f"training launches {launches}, expected "
                                  f"{expected}")
    step_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    grads_ms = [a.elapsed_time(b) for a, b, _ in events["_grads"]]
    dpps_ms = [a.elapsed_time(b) for a, b, _ in events["dpps_step"]]
    require(len(grads_ms) == 2 * steps and len(dpps_ms) == steps,
            "event count")
    # the first step also warms the allocator; the last runs profiled
    steady = slice(1, steps - 1)
    ms = sum(step_ms[steady]) / (steps - 2)
    passes = [grads_ms[2 * t] + grads_ms[2 * t + 1] for t in range(steps)]
    tokens = n * pnb * seq
    fwd = lm_flops(cfg, pnb * seq, seq)
    # a pass: the forward, its recompute under checkpoint and a backward of
    # about twice the forward, at every node
    pass_flops = 2 * n * 4 * fwd
    out = dict(
        phase="transformer_training", arch=TRAIN_LM["arch"],
        layers=cfg.total_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
        params_per_node=n_params, nodes=n, topology="DOutGraph(4, 2)",
        schedule="dense", shared_rules=repr(arch.shared_rules), d_s=d_s,
        d_local=session.partition.d_local(), per_node_batch=pnb,
        seq_len=seq, steps=steps, sync_interval=5, c_prime=c_prime, lam=lam,
        b=1.0, gamma_n=gamma_n, gamma_n_stability_limit=limit,
        gamma_n_reason="half the Remark-1 recursion's stability limit "
                       "(1/lam - 1) b / (2 C' d_s) at this d_s: above it the "
                       "sensitivity grows every round and the run diverges",
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
        session_build_s=build_s, batches_s=data_s,
        step_ms=step_ms, ms_per_step=ms, first_step_ms=step_ms[0],
        tokens_per_step=tokens, tokens_per_s=tokens / (ms / 1e3),
        grad_passes_ms=passes, dpps_round_ms=dpps_ms,
        grad_passes_ms_steady=sum(passes[steady]) / (steps - 2),
        dpps_round_ms_steady=sum(dpps_ms[steady]) / (steps - 2),
        rest_ms_steady=ms - (sum(passes[steady]) + sum(dpps_ms[steady]))
        / (steps - 2),
        profiled_step_ms=step_ms[-1],
        profiled_step_device_busy_ms=busy_ms if kernel_ms else None,
        profiled_step_device_idle_share=(
            1.0 - busy_ms / step_ms[-1] if kernel_ms else None),
        profiled_step_top_kernels=[
            dict(kernel=k[:90], ms=m, calls=c) for m, c, k in kernel_ms[:10]],
        matmul_flops_per_step=pass_flops,
        matmul_tflops_per_s=pass_flops / (ms / 1e3) / 1e12,
        resident_gb_before=resident_gb, peak_mem_gb=peak_gb,
        loss_first=loss[0], loss_last=loss[-1], losses=loss, a_mean=a_mean,
        launches=launches)
    del session, rep, state, batches, stream, loader
    torch.cuda.empty_cache()
    return out


# -- phase 16: training, the card against the CPU -----------------------------

def philox_rows(torch, ref, t: int, n: int, d_s: int, dev):
    """Round t's Philox bits (N, d_s) uint32 on the card, built in windows
    (the plain draw holds a dozen int64 copies of its window)."""
    bits = torch.empty((n, d_s), dtype=torch.uint32, device=dev)
    for c0 in range(0, d_s, 1 << 22):
        c1 = min(d_s, c0 + (1 << 22))
        bits[:, c0:c1] = ref.philox_bits(SEED, t, n, c0, c1,
                                         device=dev).to(torch.uint32)
    return bits


def training_agreement(torch, ops, ref, T, dev) -> dict:
    """llama3.2-1b at full width with 2 layers (split point clamped to 1:
    d_s = 60,821,504), N = 4, 3 steps, the same parameters, tokens and
    noise bits (``bits_at``) on the card (kernels) and on the CPU (plain
    versions). The trajectory agrees within rtol 1e-4 plus 1e-6 of each
    entry's largest magnitude, the trained state within rtol 1e-4 plus
    1e-5 of each array's largest magnitude: cuBLAS and the CPU sum the
    matmuls in other orders, and an updated weight near zero, e - gamma g,
    shows the difference of g's sums (the tied embedding's, over 64
    positions and 128,256 logits, reached 1.9e-6 of its largest
    magnitude on an H100)."""
    import dataclasses

    from repro_torch.api import PrivacySpec, Session
    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_leaves, tree_map
    from repro_torch.models.config import AttnGroup
    from repro_torch.models.transformer import Transformer

    arch = get_config("llama3.2-1b")
    cfg = dataclasses.replace(arch.model,
                              groups=(AttnGroup(n_layers=AGREE_LM["layers"]),))
    rules = tuple((pat, ("split_layers", 1) if isinstance(act, tuple)
                   else act) for pat, act in arch.shared_rules)
    model = Transformer(cfg)
    n, steps = AGREE_LM["n"], AGREE_LM["steps"]
    params = model.init(torch.Generator().manual_seed(SEED), device="cpu")
    gen = torch.Generator().manual_seed(SEED + 1)
    batches = [{"tokens": torch.randint(
        0, cfg.vocab_size, (n, AGREE_LM["per_node_batch"],
                            AGREE_LM["seq_len"]), generator=gen)}
               for _ in range(steps)]
    topo = T.DOutGraph(n, 2)
    d_s = shared_dim(torch, model, rules, n)
    c_prime, lam, _, gamma_n = stability_gamma_n(T, topo, d_s)
    bits = [philox_rows(torch, ref, t, n, d_s, dev) for t in range(steps)]
    out, launches = {}, None
    for device in ("cuda", "cpu"):
        session = Session.build(
            topo, privacy=PrivacySpec(b=1.0, gamma_n=gamma_n,
                                      c_prime=c_prime, lam=lam),
            model=model, params=tree_map(lambda x: x.to(device), params),
            partition=rules, algorithm="partpsp", gamma_l=0.05,
            gamma_s=0.05, clip=100.0, schedule="dense", sync_interval=5,
            seed=SEED, device=device)
        require(session.partition.d_shared() == d_s, "agreement d_s")
        require(session.plan.use_kernels == (device == "cuda"), "routing")
        on = [{k: v.to(device) for k, v in b.items()} for b in batches]
        bits_d = [b.to(device) for b in bits]
        ops.reset_launch_counts()
        rep = session.train(steps, lambda t: on[t],
                            bits_at=lambda t: bits_d[t])
        if device == "cuda":
            torch.cuda.synchronize()
            launches = ops.launch_counts()
        st = rep.state
        out[device] = (rep.trajectory,
                       [x.cpu() for x in tree_leaves(st.dpps.push.s)]
                       + [st.dpps.push.a.cpu()] + [x.cpu() for x in st.local])
        del session, rep, st, on, bits_d
    require(launches["l1_norm_rows"] == steps + 1
            and launches["dpps_perturb_rows"] == steps
            and launches["pushsum_mix"] == steps, f"launches {launches}")
    errs = {}
    for k, v in out["cpu"][0].items():
        g = torch.as_tensor(out["cuda"][0][k])
        w = torch.as_tensor(v)
        errs[k] = (g - w).abs().max().item()
        require(torch.allclose(g, w, rtol=1e-4,
                               atol=1e-6 * w.abs().max().item()),
                f"training agreement: {k} card {g} CPU {w}")
    state_err, worst = 0.0, []
    for i, (g, w) in enumerate(zip(out["cuda"][1], out["cpu"][1])):
        d = (g - w).abs()
        state_err = max(state_err, d.max().item())
        lim = 1e-5 * w.abs().max().item() + 1e-4 * w.abs()
        worst.append(dict(array=i, shape=list(w.shape),
                          max_abs_err=d.max().item(),
                          max_abs=w.abs().max().item(),
                          over=int((d > lim).sum())))
    require(all(x["over"] == 0 for x in worst),
            f"training agreement: the trained state differs: {worst}, "
            f"trajectory errors {errs}")
    loss = out["cuda"][0]["loss_mean"]
    del out, bits
    torch.cuda.empty_cache()
    return dict(phase="training_agreement", layers=AGREE_LM["layers"],
                nodes=n, steps=steps, d_s=d_s, gamma_n=gamma_n,
                losses=[float(x) for x in loss], trajectory_max_abs_err=errs,
                state_max_abs_err=state_err, launches=launches)


# -- phase 18: the other group kinds, the card against the CPU ----------------

def group_serve_agreement(torch, ops, dev) -> dict:
    """The five architectures of the other group kinds at their smoke
    configs (plain prefill: their smoke head dims have no flash tile),
    then zamba2-7b at full width with one unit of one Mamba2 layer and
    its shared attention block (flash, D = 112), each served on the card
    and on the CPU from the same parameters (the VLM's gates at 0.5 and
    its image embeddings the same), B = 2 (zamba2: 1), the same Gumbel
    noise: prefill logits within rtol 1e-4 / atol 1e-4 (f32 matmuls and
    softmax in other orders, through the recurrences too) and the same
    tokens."""
    import dataclasses

    from repro_torch.api import Session
    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_map
    from repro_torch.engine.rounds import gumbel
    from repro_torch.models.config import ZambaGroup
    from repro_torch.models.attention import open_cross_gates
    from repro_torch.models.transformer import Transformer

    zamba = get_config("zamba2-7b").model
    cases = {arch: (get_config(arch).smoke, 2, 64)
             for arch in GROUP_SERVE_SMOKE}
    cases["zamba2-7b_full_width_1_unit"] = (dataclasses.replace(
        zamba, flash_prefill=True, groups=(ZambaGroup(
            n_units=1, mamba_per_unit=1, d_state=zamba.groups[0].d_state,
            expand=zamba.groups[0].expand),)), 1, 256)
    gen_len = 8
    out = {}
    for name, (cfg, b, s) in cases.items():
        model = Transformer(cfg)
        cpu_gen = torch.Generator().manual_seed(SEED)
        params = open_cross_gates(model.init(cpu_gen, device="cpu"))
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                         generator=cpu_gen)}
        if cfg.groups[0].kind == "cross_self":
            batch["image_embeds"] = torch.randn(
                (b, cfg.groups[0].n_image_tokens, cfg.d_model),
                generator=cpu_gen) * 0.1
        noise = gumbel(cpu_gen, (gen_len - 1, b, cfg.vocab_size), "cpu")
        rep, launches = {}, None
        for device in ("cuda", "cpu"):
            bd = {k: v.to(device) for k, v in batch.items()}
            noise_d = noise.to(device)
            ops.reset_launch_counts()
            rep[device] = Session.build(model=model, device=device).serve(
                tree_map(lambda x: x.to(device), params), bd, gen=gen_len,
                noise_at=lambda t: noise_d[t], enc=bd.get("image_embeds"))
            if device == "cuda":
                launches = ops.launch_counts()
        want_flash = attention_layers(cfg) if cfg.flash_prefill else 0
        require(launches["flash_attention"] == want_flash
                and sum(launches.values()) == want_flash,
                f"{name}: launches {launches}")
        card, cpu = rep["cuda"], rep["cpu"]
        err = (card.logits.cpu() - cpu.logits).abs().max().item()
        require(torch.allclose(card.logits.cpu(), cpu.logits, rtol=1e-4,
                               atol=1e-4), f"{name} logits card vs CPU: {err}")
        require(torch.equal(card.tokens.cpu(), cpu.tokens),
                f"{name} tokens card {card.tokens.tolist()} vs CPU "
                f"{cpu.tokens.tolist()}")
        out[name] = dict(batch=b, prompt=s, gen=gen_len,
                         head_dim=cfg.head_dim, flash=cfg.flash_prefill,
                         logits_max_abs_err=err, tokens_equal=True,
                         flash_launches=launches["flash_attention"])
        del params, rep, card, cpu
    torch.cuda.empty_cache()
    return dict(phase="group_serve_agreement", results=out)


# -- phase 19: PartPSP training of the other group kinds at full width --------

def group_train_config(run: dict):
    """(ArchSpec, ModelConfig) of a :data:`GROUP_TRAIN_RUNS` entry: the
    arch's published config with its one group cut as ``run["cut"]``
    says."""
    import dataclasses

    from repro_torch.configs import get_config

    spec = get_config(run["arch"])
    cfg = spec.model
    if run["cut"]:
        (group,) = cfg.groups
        cfg = dataclasses.replace(cfg, groups=(
            dataclasses.replace(group, **run["cut"]),))
    return spec, cfg


def lm_batch_at(torch, cfg, n: int, dev, steps: int) -> list:
    """``steps`` node-stacked batches of ``NodeShardedLoader(
    SyntheticLMStream(...))`` (GROUP_TRAIN's per-node batch and length);
    a VLM's carry image embeddings (normal x 0.1, (N, B, M, d_model)) from
    a generator seeded with SEED + 1, as the serve phases draw them."""
    from repro_torch.data import NodeShardedLoader, SyntheticLMStream

    pnb, seq = GROUP_TRAIN["per_node_batch"], GROUP_TRAIN["seq_len"]
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size, seq_len=seq,
                               n_nodes=n, seed=SEED, device=dev)
    loader = NodeShardedLoader(stream, per_node_batch=pnb, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = []
    for t in range(steps):
        batch = dict(loader.batch_at(t))
        if cfg.groups[0].kind == "cross_self":
            batch["image_embeds"] = torch.randn(
                (n, pnb, cfg.groups[0].n_image_tokens, cfg.d_model),
                generator=gen, device=dev) * 0.1
        out.append(batch)
    return out


def group_train_run(torch, ops, T, dev, label: str) -> tuple:
    """Run ``label`` of :data:`GROUP_TRAIN_RUNS` (a-c): ``Session.build(
    DOutGraph(N, 2), model=Transformer(cfg), params=its seeded init (the
    VLM's gates at 0.5), partition=the arch's rules, schedule="dense")``
    on the card, then ``train(3, batch_at)``, with the figures of phase 15:
    ms a step (host clock, a synchronise at each step's start; steady =
    the mean of steps 1-2), tokens/s, its two gradient passes against its
    DPPS round (CUDA events), peak memory and the exact kernel launches.
    Each recurrent time loop (``ssm._mlstm_scan``, ``_slstm_scan``,
    ``_mamba2_scan``) is bracketed by CUDA events: their forward and
    recompute time a step (their backward is in the passes' rest). gamma_n
    is half the Remark-1 stability limit at the run's d_s. Returns (the
    figures, (session, final state))."""
    from repro_torch.api import PrivacySpec, Session
    from repro_torch.core import partpsp
    from repro_torch.core.tree_utils import tree_leaves
    from repro_torch.models import ssm
    from repro_torch.models.attention import open_cross_gates
    from repro_torch.models.transformer import Transformer

    run = GROUP_TRAIN_RUNS[label]
    spec, cfg = group_train_config(run)
    n, steps = run["n"], GROUP_TRAIN["steps"]
    pnb, seq = GROUP_TRAIN["per_node_batch"], GROUP_TRAIN["seq_len"]
    sync = GROUP_TRAIN["sync_interval"]
    model = Transformer(cfg)
    d_s = shared_dim(torch, model, spec.shared_rules, n)
    require(d_s == run["d_s"], f"run {label}: d_s {d_s}")
    topo = T.DOutGraph(n, 2)
    c_prime, lam, limit, gamma_n = stability_gamma_n(T, topo, d_s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = open_cross_gates(model.init(
        torch.Generator(device=dev).manual_seed(SEED), device=dev))
    session = Session.build(
        topo, privacy=PrivacySpec(b=1.0, gamma_n=gamma_n, c_prime=c_prime,
                                  lam=lam),
        model=model, params=params, partition=spec.shared_rules,
        algorithm="partpsp", gamma_l=0.05, gamma_s=0.05, clip=100.0,
        schedule="dense", sync_interval=sync, seed=SEED, device=dev)
    del params
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    require(session.plan.use_kernels and session.device.type == "cuda"
            and session.plan.schedule == "dense",
            f"run {label}: not on the card, its kernels and the dense "
            "schedule")
    n_params = sum(x[0].numel() for x in tree_leaves(session.init_params))
    batches = lm_batch_at(torch, cfg, n, dev, steps)
    require(tuple(batches[0]["tokens"].shape) == (n, pnb, seq), "batch shape")

    starts = []

    def batch_at(t):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return batches[t]

    loops = ("_mlstm_scan", "_slstm_scan", "_mamba2_scan")
    events, loop_events = {}, {}
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    restore = [bracketed(torch, partpsp, ("_grads", "dpps_step"), events),
               bracketed(torch, ssm, loops, loop_events)]
    try:
        rep = session.train(steps, batch_at)
        torch.cuda.synchronize()
    finally:
        for r in restore:
            r()
    starts.append(time.perf_counter())
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    loss = [float(x) for x in rep.trajectory["loss_mean"]]
    require(all(math.isfinite(x) for x in loss), f"run {label}: losses {loss}")
    # falling or flat: each step draws a new batch, so "flat" allows 1 %
    require(loss[-1] <= 1.01 * loss[0], f"run {label}: losses rise {loss}")
    state = rep.state
    a_mean = state.dpps.push.a.double().mean().item()
    require(abs(a_mean - 1.0) < 1e-5, f"run {label}: mean(a) = {a_mean}")
    require(all(bool(torch.isfinite(x).all()) for x in
                tree_leaves(state.dpps.push.s) + list(state.local)),
            f"run {label}: trained state not finite")
    expected = training_launches(steps, sync)
    require(launches == expected, f"run {label}: launches {launches}, "
                                  f"expected {expected}")
    step_ms = [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]
    grads_ms = [a.elapsed_time(b) for a, b, _ in events["_grads"]]
    dpps_ms = [a.elapsed_time(b) for a, b, _ in events["dpps_step"]]
    require(len(grads_ms) == 2 * steps and len(dpps_ms) == steps,
            "event count")
    loop_ms = {name: sum(a.elapsed_time(b) for a, b, _ in ev) / steps
               for name, ev in loop_events.items()}
    steady = slice(1, steps)  # the first step also warms the allocator
    ms = sum(step_ms[steady]) / (steps - 1)
    passes = [grads_ms[2 * t] + grads_ms[2 * t + 1] for t in range(steps)]
    tokens = n * pnb * seq
    out = dict(
        run=label, arch=run["arch"], cut=run["cut"],
        layers=cfg.total_layers, d_model=cfg.d_model, vocab=cfg.vocab_size,
        params_per_node=n_params, nodes=n, topology=f"DOutGraph({n}, 2)",
        schedule="dense", shared_rules=repr(spec.shared_rules), d_s=d_s,
        d_local=session.partition.d_local(), per_node_batch=pnb,
        seq_len=seq, image_tokens=batches[0]["image_embeds"].shape[2]
        if "image_embeds" in batches[0] else None, steps=steps,
        sync_interval=sync, c_prime=c_prime, lam=lam, b=1.0,
        gamma_n=gamma_n, gamma_n_stability_limit=limit,
        session_build_s=build_s, step_ms=step_ms, ms_per_step=ms,
        first_step_ms=step_ms[0], tokens_per_step=tokens,
        tokens_per_s=tokens / (ms / 1e3), grad_passes_ms=passes,
        dpps_round_ms=dpps_ms,
        grad_passes_ms_steady=sum(passes[steady]) / (steps - 1),
        dpps_round_ms_steady=sum(dpps_ms[steady]) / (steps - 1),
        rest_ms_steady=ms - (sum(passes[steady]) + sum(dpps_ms[steady]))
        / (steps - 1),
        recurrent_loop_fwd_ms_per_step=loop_ms,
        recurrent_loop_fwd_share_of_step=sum(loop_ms.values())
        / (sum(step_ms) / steps),
        resident_gb_before=resident_gb, peak_mem_gb=peak_gb,
        loss_first=loss[0], loss_last=loss[-1], losses=loss, a_mean=a_mean,
        launches=launches)
    del rep, batches
    return out, (session, state, cfg)


def moe_grad_run(torch, dev) -> dict:
    """Run d: llama4-scout at full width, one of its 48 layers, one node:
    ``Transformer.loss_fn`` (the cross entropy plus the MoE aux) and its
    backward over every parameter, on one node's batch of GROUP_TRAIN's
    size, twice (the second is the steady figure). PartPSP does not fit:
    at N = 2 the params alone take 34 GB and the local gradients another
    33.7 GB. Requires a finite loss, a positive aux and finite gradients,
    the router's nonzero."""
    from repro_torch.core.tree_utils import tree_flatten_with_path
    from repro_torch.models.transformer import Transformer

    run = GROUP_TRAIN_RUNS["d"]
    spec, cfg = group_train_config(run)
    model = Transformer(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    named = tree_flatten_with_path(params)[0]
    for _, x in named:
        x.requires_grad_(True)
    n_params = sum(x.numel() for _, x in named)
    batch = {"tokens": lm_batch_at(torch, cfg, 1, dev, 1)[0]["tokens"][0]}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms, loss = [], None
    for _ in range(2):
        grads = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss_fn(params, batch)
        grads = torch.autograd.grad(loss, [x for _, x in named])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with torch.no_grad():
        _, aux = model.forward_train(params, batch)
    loss = loss.item()
    require(math.isfinite(loss) and float(aux) > 0.0,
            f"run d: loss {loss}, aux {float(aux)}")
    require(all(bool(torch.isfinite(g).all()) for g in grads),
            "run d: gradients not finite")
    router = [float(g.abs().max()) for (p, _), g in zip(named, grads)
              if p.endswith("router")]
    require(router and all(r > 0.0 for r in router),
            f"run d: router gradient {router}")
    tokens = batch["tokens"].numel()
    out = dict(run="d", arch=run["arch"], cut=run["cut"],
               layers=cfg.total_layers, d_model=cfg.d_model,
               vocab=cfg.vocab_size, experts=cfg.groups[0].n_experts,
               params=n_params, d_s_under_its_rules=run["d_s"], nodes=1,
               partpsp=False, per_node_batch=GROUP_TRAIN["per_node_batch"],
               seq_len=GROUP_TRAIN["seq_len"], pass_ms=ms,
               pass_ms_steady=ms[-1], tokens_per_s=tokens / (ms[-1] / 1e3),
               peak_mem_gb=peak_gb, loss=loss, aux=float(aux),
               router_grad_max_abs=router[0])
    del params, named, grads, loss
    return out


def serve_view(torch, ops, dev, model, params, prompt, noise):
    """``Session.build(model=model).serve`` of ``params`` on ``prompt``
    (1, S) with the decode's Gumbel ``noise`` (gen - 1, 1, V) -> (report,
    launches)."""
    from repro_torch.api import Session

    ops.reset_launch_counts()
    rep = Session.build(model=model, seed=SEED, device=dev).serve(
        params, {"tokens": prompt}, gen=CHECKPOINT_SERVE["gen"],
        noise_at=lambda t: noise[t])
    torch.cuda.synchronize()
    return rep, ops.launch_counts()


def group_training(torch, ops, T, dev, ckpt_dir: str) -> tuple:
    """Runs a-d of :data:`GROUP_TRAIN_RUNS`. After run b, its consensus
    (``Session.save_consensus``) goes to ``ckpt_dir`` and the in-memory
    ``consensus_view`` is served (flash prefill, D = 112) for phase 20 to
    compare with; that serve's launches are phase 20's."""
    import dataclasses

    from repro_torch.engine.rounds import gumbel
    from repro_torch.models.transformer import Transformer

    runs, launches, memory_serve = {}, {k: 0 for k in KERNELS}, None
    for label in ("a", "b", "c"):
        out, (session, state, cfg) = group_train_run(torch, ops, T, dev,
                                                     label)
        runs[label] = out
        for k, v in out["launches"].items():
            launches[k] += v
        if label == "b":
            t0 = time.perf_counter()
            session.save_consensus(ckpt_dir, state,
                                   step=GROUP_TRAIN["steps"],
                                   metadata={"arch": out["arch"],
                                             "algorithm": "partpsp"})
            save_s = time.perf_counter() - t0
            model = Transformer(dataclasses.replace(cfg, flash_prefill=True))
            gen = torch.Generator().manual_seed(SEED + 2)
            prompt = torch.randint(0, cfg.vocab_size,
                                   (1, CHECKPOINT_SERVE["prompt"]),
                                   generator=gen).to(dev)
            noise = gumbel(gen, (CHECKPOINT_SERVE["gen"] - 1, 1,
                                 cfg.vocab_size), "cpu").to(dev)
            rep, served = serve_view(torch, ops, dev, model,
                                     session.consensus_view(state, 0),
                                     prompt, noise)
            memory_serve = dict(model=model, prompt=prompt, noise=noise,
                                logits=rep.logits, tokens=rep.tokens,
                                launches=served, save_s=save_s)
            del rep
        del session, state
        torch.cuda.empty_cache()
    runs["d"] = moe_grad_run(torch, dev)
    torch.cuda.empty_cache()
    return dict(phase="group_training", **GROUP_TRAIN, runs=runs,
                launches=launches), memory_serve


# -- phase 20: the consensus checkpoint from train to serve --------------------

def checkpoint_serve(torch, ops, dev, ckpt_dir: str, memory: dict) -> dict:
    """Run b's consensus as ``launch/serve.py --checkpoint`` restores it
    (``model_params``: a fresh model's params, then ``load_checkpoint``
    into them), served on the same prompt and Gumbel noise as the
    in-memory ``consensus_view`` was in phase 19: the prefill logits equal
    bit for bit and the tokens equal (the same card, the same kernels);
    one flash launch (one unit) a serve."""
    import os

    from repro_torch.core.tree_utils import tree_leaves
    from repro_torch.launch import serve as serve_cli

    model = memory["model"]
    t0 = time.perf_counter()
    params, _, meta = serve_cli.model_params(model, dev, seed=SEED + 3,
                                             checkpoint=ckpt_dir)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(meta["step"] == GROUP_TRAIN["steps"]
            and meta["user"] == {"arch": GROUP_TRAIN_RUNS["b"]["arch"],
                                 "algorithm": "partpsp"},
            f"checkpoint meta {meta['step']}, {meta['user']}")
    require(all(x.device.type == "cuda" for x in tree_leaves(params)),
            "restored params not on the card")
    rep, served = serve_view(torch, ops, dev, model, params, memory["prompt"],
                             memory["noise"])
    launches = {k: memory["launches"][k] + served[k] for k in KERNELS}
    require(served["flash_attention"] == 1
            and memory["launches"]["flash_attention"] == 1
            and sum(launches.values()) == 2,
            f"checkpoint serve launches {memory['launches']}, {served}")
    require(bool(torch.isfinite(rep.logits).all()), "logits not finite")
    err = (rep.logits - memory["logits"]).abs().max().item()
    require(torch.equal(rep.logits, memory["logits"]),
            f"restored logits differ from the in-memory view's: {err}")
    require(torch.equal(rep.tokens, memory["tokens"]),
            f"tokens {rep.tokens.tolist()} vs {memory['tokens'].tolist()}")
    nbytes = os.path.getsize(os.path.join(ckpt_dir, "tensors.npz"))
    out = dict(phase="checkpoint_serve", arch=GROUP_TRAIN_RUNS["b"]["arch"],
               cut=GROUP_TRAIN_RUNS["b"]["cut"], leaves=len(meta["names"]),
               checkpoint_gb=nbytes / 1e9, save_s=memory["save_s"],
               load_s=load_s, prompt=CHECKPOINT_SERVE["prompt"],
               gen=CHECKPOINT_SERVE["gen"], prefill_s=rep.prefill_s,
               logits_bitwise_equal=True, logits_max_abs_err=err,
               tokens=rep.tokens[0].tolist(), launches=launches)
    del params, rep
    torch.cuda.empty_cache()
    return out


# -- phase 21: training the other group kinds, the card against the CPU --------

def group_training_agreement(torch, ops, ref, T, dev) -> dict:
    """The five smoke configs of the other group kinds (scout, maverick
    with ``moe_every = 2``, xlstm, zamba2, vision with image embeddings and
    its gates at 0.5), each arch's rules, N = 4, 3 rounds, noise off and on
    (half the Remark-1 limit; the same Philox rows fed to both through
    ``bits_at``): ``Session.train`` on the card (kernels) and on the CPU
    (plain versions) from the same parameters and batches. Every MoE
    token's top-1 margin is above 1e-4 on both, so routing cannot flip.
    Tolerances as phase 16's: the trajectory rtol 1e-4 plus 1e-6 of each
    entry's largest magnitude, the trained state rtol 1e-4 plus 1e-5 of
    each array's largest magnitude."""
    from repro_torch.api import PrivacySpec, Session
    from repro_torch.configs import get_config
    from repro_torch.core.tree_utils import tree_leaves, tree_map
    from repro_torch.models import moe
    from repro_torch.models.attention import open_cross_gates
    from repro_torch.models.transformer import Transformer

    n, steps = GROUP_AGREE["n"], GROUP_AGREE["steps"]
    pnb, seq = GROUP_AGREE["per_node_batch"], GROUP_AGREE["seq_len"]
    real_route, margins = moe.moe_route, []

    def route(router, tokens, n_experts, cap):
        r = real_route(router, tokens, n_experts, cap)
        top2 = torch.topk(r["probs"].detach(), 2, dim=-1).values
        margins.append(float((top2[:, 0] - top2[:, 1]).min()))
        return r

    out = {}
    moe.moe_route = route
    try:
        for arch in GROUP_SERVE_SMOKE:
            spec = get_config(arch)
            cfg, rules = spec.smoke, spec.shared_rules
            model = Transformer(cfg)
            params = open_cross_gates(model.init(
                torch.Generator().manual_seed(GROUP_AGREE["seed"]),
                device="cpu"))
            gen = torch.Generator().manual_seed(GROUP_AGREE["seed"] + 1)
            batches = []
            for _ in range(steps):
                b = {"tokens": torch.randint(0, cfg.vocab_size, (n, pnb, seq),
                                             generator=gen)}
                if cfg.groups[0].kind == "cross_self":
                    b["image_embeds"] = torch.randn(
                        (n, pnb, cfg.groups[0].n_image_tokens, cfg.d_model),
                        generator=gen) * 0.1
                batches.append(b)
            topo = T.DOutGraph(n, 2)
            d_s = shared_dim(torch, model, rules, n)
            c_prime, lam, _, gamma_n = stability_gamma_n(T, topo, d_s)
            bits = [philox_rows(torch, ref, t, n, d_s, dev)
                    for t in range(steps)]
            for noise in (False, True):
                res, launches, margin = {}, None, {}
                for key, device in (("card", dev), ("cpu", "cpu")):
                    session = Session.build(
                        topo, privacy=PrivacySpec(
                            b=1.0, gamma_n=gamma_n, noise=noise,
                            c_prime=c_prime, lam=lam),
                        model=model,
                        params=tree_map(lambda x: x.to(device), params),
                        partition=rules, algorithm="partpsp", gamma_l=0.05,
                        gamma_s=0.05, clip=100.0, schedule="dense",
                        sync_interval=5, seed=SEED, device=device)
                    require(session.plan.use_kernels == (key == "card"),
                            "routing")
                    on = [{k: v.to(device) for k, v in b.items()}
                          for b in batches]
                    bits_d = [x.to(device) for x in bits]
                    margins.clear()
                    ops.reset_launch_counts()
                    rep = session.train(
                        steps, lambda t: on[t],
                        bits_at=(lambda t: bits_d[t]) if noise else None)
                    if key == "card":
                        torch.cuda.synchronize()
                        launches = ops.launch_counts()
                    margin[key] = min(margins) if margins else None
                    st = rep.state
                    res[key] = (
                        rep.trajectory,
                        [x.cpu() for x in tree_leaves(st.dpps.push.s)]
                        + [st.dpps.push.a.cpu()]
                        + [x.cpu() for x in st.local])
                    del session, rep, st, on, bits_d
                name = f"{arch}/noise_{'on' if noise else 'off'}"
                require(all(m is None or m > 1e-4 for m in margin.values()),
                        f"{name}: top-1 routing margins {margin}")
                want = dict(l1_norm_rows=steps + 1, pushsum_mix=steps,
                            dpps_perturb_rows=steps if noise else 0)
                require(all(launches[k] == v for k, v in want.items())
                        and sum(launches.values()) == sum(want.values()),
                        f"{name}: launches {launches}, expected {want}")
                errs = {}
                for k, v in res["cpu"][0].items():
                    g = torch.as_tensor(res["card"][0][k])
                    w = torch.as_tensor(v)
                    errs[k] = (g - w).abs().max().item()
                    require(torch.allclose(g, w, rtol=1e-4,
                                           atol=1e-6 * w.abs().max().item()),
                            f"{name}: {k} card {g} CPU {w}")
                state_err = 0.0
                for g, w in zip(res["card"][1], res["cpu"][1]):
                    d = (g - w).abs()
                    state_err = max(state_err, d.max().item())
                    lim = 1e-5 * w.abs().max().item() + 1e-4 * w.abs()
                    require(bool((d <= lim).all()),
                            f"{name}: trained state differs by "
                            f"{d.max().item()} (trajectory errors {errs})")
                out[name] = dict(
                    d_s=d_s, gamma_n=gamma_n if noise else 0.0,
                    losses=[float(x) for x in res["card"][0]["loss_mean"]],
                    trajectory_max_abs_err=errs,
                    state_max_abs_err=state_err, min_routing_margin=margin,
                    launches=launches)
                del res
            del bits
    finally:
        moe.moe_route = real_route
    torch.cuda.empty_cache()
    return dict(phase="group_training_agreement", nodes=n, steps=steps,
                per_node_batch=pnb, seq_len=seq, results=out)


# -- phase 22: the per-round loop driver and the hooks at full width ---------

def tree_launches(leaves: int, t0: int, steps: int, sync_interval: int,
                  mix: str = "pushsum_mix") -> dict:
    """The exact launches of ``steps`` PartPSP rounds from round ``t0`` with
    noise on, over ``leaves`` shared leaves: a norm and a perturbation a
    leaf a round (round 0 also a norm a leaf of s for the recursion's
    start) and a mix a leaf a round that is not a sync round (the packed
    engine is ``leaves`` = 1)."""
    from repro_torch.core.dpps import is_sync_round

    expected = {k: 0 for k in KERNELS}
    expected.update(
        l1_norm_rows=leaves * (steps + (1 if t0 == 0 else 0)),
        dpps_perturb_rows=leaves * steps,
        **{mix: leaves * sum(not is_sync_round(t, sync_interval)
                             for t in range(t0, t0 + steps))})
    return expected


def state_leaves(torch, state, device=None) -> list:
    """The tensors of a PartPSP state in tree order (on ``device``)."""
    from repro_torch.core.tree_utils import tree_leaves

    return [x if device is None else x.to(device)
            for x in tree_leaves(state) if isinstance(x, torch.Tensor)]


def states_agree(torch, got: list, want: list, rtol: float = 1e-4,
                 atol_rel: float = 1e-5) -> dict:
    """Leaf by leaf (``want`` may lie on the host): the largest error, and
    the leaves off rtol plus atol_rel of the leaf's largest magnitude."""
    worst, bad = 0.0, []
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.to(g.device)
        err, ok = compare(g.reshape(g.shape[0], -1) if g.dim() else g[None],
                          w.reshape(w.shape[0], -1) if w.dim() else w[None],
                          rtol, atol_rel * w.abs().max().item())
        worst = max(worst, err)
        if not ok:
            bad.append(dict(leaf=i, shape=list(w.shape), max_abs_err=err))
        del w
    return dict(max_abs_err=worst, off=bad, leaves=len(got))


def lm_session(torch, T, layers: int | None = None, **build_kw):
    """phase 15's session: llama3.2-1b at full width, its rules, N = 4,
    2-out, dense schedule, gamma_n half the stability limit; with its
    batches (made before the runs). ``layers`` cuts the model to its first
    layers (phase 23; at least the four its rule shares). ``build_kw``
    goes to ``Session.build`` (phase 24's ``faults=``)."""
    import dataclasses

    from repro_torch.api import PrivacySpec, Session
    from repro_torch.configs import get_config
    from repro_torch.data import NodeShardedLoader, SyntheticLMStream
    from repro_torch.models.transformer import Transformer

    arch = get_config(TRAIN_LM["arch"])
    cfg = arch.model
    if layers is not None:
        (group,) = cfg.groups
        cfg = dataclasses.replace(cfg, groups=(
            dataclasses.replace(group, n_layers=layers),))
    n = TRAIN_LM["n"]
    topo = T.DOutGraph(n, 2)
    model = Transformer(cfg)
    d_s = shared_dim(torch, model, arch.shared_rules, n)
    require(d_s == TRAIN_LM["d_s"], f"d_s {d_s}")
    c_prime, lam, _, gamma_n = stability_gamma_n(T, topo, d_s)
    session = Session.build(
        topo, privacy=PrivacySpec(b=1.0, gamma_n=gamma_n, c_prime=c_prime,
                                  lam=lam),
        model=model, partition=arch.shared_rules, algorithm="partpsp",
        gamma_l=0.05, gamma_s=0.05, clip=100.0, schedule="dense",
        sync_interval=5, seed=SEED, **build_kw)
    require(session.plan.use_kernels and session.device.type == "cuda",
            "the session did not pick the card and its kernels")
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size,
                               seq_len=TRAIN_LM["seq_len"], n_nodes=n,
                               seed=SEED)
    loader = NodeShardedLoader(stream, per_node_batch=TRAIN_LM[
        "per_node_batch"], seed=SEED)
    batches = [loader.batch_at(t) for t in range(max(LOOP_STEPS,
                                                     sum(RESUME_SPLIT)))]
    return session, batches, gamma_n


def timed_train(torch, session, batches, steps: int, events: dict, **kw):
    """``session.train`` with each step's host time (a synchronise at its
    start), CUDA events around each DPPS round (``events["dpps_step"]``)
    and around each round's hook captures (``events["capture_rows"]``: the
    hooks' ``capture``, the real-sensitivity pass among them, which runs
    after the DPPS round in both drivers); ``kw`` goes to ``train``."""
    from repro_torch.api import hooks, session as session_mod
    from repro_torch.core import partpsp

    starts = []

    def batch_at(t):
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        return batches[t]

    # the engine imports capture_rows from the hooks module at each run, the
    # loop driver calls the session module's name
    restores = [bracketed(torch, partpsp, ("dpps_step",), events),
                bracketed(torch, hooks, ("capture_rows",), events),
                bracketed(torch, session_mod, ("capture_rows",), events)]
    try:
        rep = session.train(steps, batch_at, **kw)
        torch.cuda.synchronize()
    finally:
        for restore in restores:
            restore()
    starts.append(time.perf_counter())
    return rep, [(b - a) * 1e3 for a, b in zip(starts, starts[1:])]


LEDGER_ACCOUNTING = ("round", "mechanism", "algorithm", "wire_dtype",
                     "wire_codec", "protected", "synced", "epsilon_round",
                     "epsilon_total", "remaining", "exhausted")


def loop_hooks(api, path: str):
    warned, lines = [], []
    return [api.LedgerHook(path), api.BudgetHook(1e12, warn=warned.append),
            api.MetricsHook(print_fn=lines.append, log_every=1),
            api.RealSensitivityHook(chunk=1)], warned, lines


def leaves_agree(got: list, want: list, rtol: float, atol: float) -> tuple:
    """(largest error, every leaf within atol + rtol |want|) over two lists
    of node-stacked leaves on the card."""
    err, ok = 0.0, True
    for g, w in zip(got, want):
        e, k = compare(g.reshape(g.shape[0], -1), w.reshape(w.shape[0], -1),
                       rtol, atol)
        err, ok = max(err, e), ok and k
    return err, ok


def norms_rel(torch, got, want) -> float:
    return ((got.double() - want.double()).abs()
            / want.double().abs()).max().item()


def tree_checks(torch, ops, ref, dev, shapes: list, n: int, gossip,
                mix: str, mix_tol: tuple) -> dict:
    """The tree entry points on seeded leaves of ``shapes`` (N = ``n``), each
    against its plain version on the same card tensors: ``l1_norm_tree``
    (norms rel 1e-5: per-block partials against PyTorch's reduction order),
    ``dpps_perturb_tree`` (s_noise rtol 1e-6 / atol 1e-6: the card's logf may
    differ by an ulp; its norms rel 1e-5) and ``gossip(state, use_kernels)``,
    a ``mix`` launch a leaf (rtol, atol = ``mix_tol``, the kernel's
    tolerance against its plain version). Then each perturbation launch bit
    for bit against one launch over the packed row, leaf by leaf, with each
    leaf's first wire column."""
    from repro_torch.core.pushsum import PushSumState

    gen = torch.Generator(device=dev).manual_seed(SEED)
    s = [torch.randn((n,) + tuple(sh), generator=gen, device=dev)
         for sh in shapes]
    eps = [torch.randn((n,) + tuple(sh), generator=gen, device=dev)
           for sh in shapes]
    scale = torch.tensor(0.7, device=dev)
    out = {}

    rel = norms_rel(torch, ops.l1_norm_tree(s), ref.l1_norm_tree(s))
    require(rel < 1e-5, f"l1_norm_tree off its plain version by {rel}")
    out["l1_norm_tree_rel_err"] = rel

    got, g_eps, g_noise = ops.dpps_perturb_tree(s, eps, scale, 0.1,
                                                seed=SEED, t=3)
    want, w_eps, w_noise = ref.dpps_perturb_tree(s, eps, scale, 0.1,
                                                 seed=SEED, t=3)
    err, ok = leaves_agree(got, want, rtol=1e-6, atol=1e-6)
    bit_equal = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
    del want
    rels = [norms_rel(torch, g_eps, w_eps), norms_rel(torch, g_noise,
                                                      w_noise)]
    require(ok and max(rels) < 1e-5,
            f"dpps_perturb_tree off its plain version: s_noise {err}, "
            f"eps_l1 / noise_l1 rel {rels}")
    out["dpps_perturb_tree"] = dict(max_abs_err=err, bit_equal=bit_equal,
                                    eps_l1_rel_err=rels[0],
                                    noise_l1_rel_err=rels[1])

    state = PushSumState(s=s, a=torch.ones(n, device=dev))
    k_state = gossip(state, True)
    p_state = gossip(state, False)
    err, ok = leaves_agree(k_state.s, p_state.s, *mix_tol)
    require(ok and torch.equal(k_state.a, p_state.a),
            f"the tree gossip through {mix} off its plain version: {err}")
    out[f"{mix}_tree"] = dict(max_abs_err=err, rtol=mix_tol[0],
                              atol=mix_tol[1])
    del state, k_state, p_state

    cols = ref.leaf_columns(s)
    d_s = cols[-1] + s[-1][0].numel()
    row = torch.empty((n, -(-d_s // 4) * 4), device=dev)
    for x, c0 in zip(s, cols):
        row[:, c0:c0 + x[0].numel()] = x.reshape(n, -1)
    del s
    erow = torch.empty_like(row)
    for x, c0 in zip(eps, cols):
        erow[:, c0:c0 + x[0].numel()] = x.reshape(n, -1)
    del eps
    packed = ops.dpps_perturb_rows(row, erow, scale, 0.1, d_s, seed=SEED,
                                   t=3)[0]
    del row, erow
    bits = []
    for x, c0 in zip(got, cols):
        size = x[0].numel()
        bits.append(dict(col0=c0, size=size, col0_mod4=c0 % 4,
                         bit_equal=bool(torch.equal(
                             x.reshape(n, size), packed[:, c0:c0 + size]))))
    del got, packed
    torch.cuda.empty_cache()
    require(all(r["bit_equal"] for r in bits),
            f"tree launches off the packed launch's columns: {bits}")
    out["perturb_bits_against_packed"] = bits
    return out


def loop_training(torch, api, mlp, data, ops, ref, T, dev,
                  tmp: str) -> tuple:
    """Phase 22. ``Session.train(3, driver="loop")`` of phase 15's session
    (llama3.2-1b full width, N = 4) under ``LedgerHook``, ``BudgetHook``,
    ``MetricsHook`` and ``RealSensitivityHook``, then ``driver="engine"``
    with the same hooks, batches and seed: ms a step and a DPPS round (CUDA
    events) and the hooks' captures (CUDA events) for both, exact launches
    (the loop a kernel a shared leaf), loop against engine (state and
    trajectory to rtol 1e-4 plus 1e-5 of each array's largest magnitude,
    the training tolerance: the loop sums its norms a leaf at a time), the
    ledgers' accounting fields equal, no real-sensitivity violation, peak
    memory. Then :func:`tree_checks` at llama's shared leaves (the dense
    gossip) and the MLP's (the sparse gossip on ER(128)): every tree entry
    point against its plain version, each tree perturbation launch bit for
    bit against the packed launch's columns; and the paper MLP on ER(128),
    sparse, loop against engine (:func:`mlp_drivers`, no faults). Returns
    (line, session, batches, launch counts) for phase 23."""
    import os

    from repro_torch.audit import PrivacyLedger
    from repro_torch.core import pushsum

    t0 = time.perf_counter()
    session, batches, gamma_n = lm_session(torch, T)
    build_s = time.perf_counter() - t0
    shared = session.train_state().dpps.push.s
    leaves = len(shared)
    shapes = [tuple(x.shape[1:]) for x in shared]
    del shared
    steps = LOOP_STEPS
    out, counts, ledgers, host = {}, [], {}, None
    for driver in ("loop", "engine"):
        path = os.path.join(tmp, f"ledger_{driver}.jsonl")
        hooks, warned, lines = loop_hooks(api, path)
        events = {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rep, step_ms = timed_train(torch, session, batches, steps, events,
                                   hooks=hooks, driver=driver)
        launches = ops.launch_counts()
        counts.append(launches)
        want = tree_launches(leaves if driver == "loop" else 1, 0, steps, 5)
        require(launches == want, f"{driver} launches {launches}, expected "
                                  f"{want}")
        real = hooks[3]
        require(real.violations == 0 and len(real.reals) == steps,
                f"{driver}: real sensitivity {real.reals} violations "
                f"{real.violations}")
        loss = [float(x) for x in rep.trajectory["loss_mean"]]
        require(all(math.isfinite(x) for x in loss), f"{driver} losses {loss}")
        require(not rep.aborted and not warned and len(lines) == steps,
                f"{driver}: aborted {rep.aborted}, warned {warned}")
        ledgers[driver] = PrivacyLedger.read_jsonl(path)
        dpps_ms = [a.elapsed_time(b) for a, b, _ in events["dpps_step"]]
        capture_ms = [a.elapsed_time(b) for a, b, _ in events["capture_rows"]]
        require(len(dpps_ms) == len(capture_ms) == steps,
                f"{driver}: {len(dpps_ms)} DPPS rounds and {len(capture_ms)} "
                f"hook captures timed in {steps} steps")
        out[driver] = dict(
            step_ms=step_ms, ms_per_step=sum(step_ms[1:]) / (steps - 1),
            dpps_round_ms=dpps_ms,
            dpps_round_ms_steady=sum(dpps_ms[1:]) / (steps - 1),
            hooks_capture_ms=capture_ms,
            hooks_capture_ms_steady=sum(capture_ms[1:]) / (steps - 1),
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            losses=loss, sensitivity_real=real.reals,
            sensitivity_used=[float(x) for x in
                              rep.trajectory["sensitivity_used"]],
            real_sensitivity_violations=real.violations,
            ledger_summary=hooks[0].summary(), launches=launches,
            expected_launches=want, wire_bytes=rep.wire_bytes)
        if driver == "loop":
            host = (state_leaves(torch, rep.state, "cpu"),
                    dict(rep.trajectory))
        else:
            agree = states_agree(torch, state_leaves(torch, rep.state),
                                 host[0])
            require(not agree["off"], f"loop against engine: {agree}")
            traj_err = {}
            for k, v in rep.trajectory.items():
                g, w = torch.as_tensor(host[1][k]), torch.as_tensor(v)
                traj_err[k] = (g - w).abs().max().item()
                require(torch.allclose(g.double(), w.double(), rtol=1e-4,
                                       atol=1e-6 * w.abs().max().item()),
                        f"trajectory {k}: loop {g} engine {w}")
        del rep
        torch.cuda.empty_cache()
    del host
    require(len(ledgers["loop"]) == len(ledgers["engine"]) == steps
            and all(a[k] == b[k] for a, b in zip(ledgers["loop"],
                                                  ledgers["engine"])
                    for k in LEDGER_ACCOUNTING),
            f"ledgers differ: {ledgers}")
    w = T.DOutGraph(TRAIN_LM["n"], 2).weight_matrix_torch(0, device=dev)
    # rtol 1e-5 / atol 1e-6: fma in j order against cuBLAS's order
    lm_tree = tree_checks(
        torch, ops, ref, dev, shapes, TRAIN_LM["n"],
        lambda st, k: pushsum.gossip_dense(st, w, use_kernels=k),
        "pushsum_mix", (1e-5, 1e-6))
    idx, vals, _, _ = csr_of(torch, sparse_graph(SPARSE_TRAIN_N), dev)
    # rtol 1e-6 / atol 1e-6: fma against a separate multiply and add
    mlp_tree = tree_checks(
        torch, ops, ref, dev, MLP_BIAS_SHAPES, SPARSE_TRAIN_N,
        lambda st, k: pushsum.gossip_sparse(st, idx, vals, use_kernels=k),
        "spmm", (1e-6, 1e-6))
    require(any(r["col0_mod4"]
                for r in mlp_tree["perturb_bits_against_packed"]),
            "no straddling leaf")
    mlp_run = mlp_drivers(torch, api, mlp, data, ops, dev,
                          topo=sparse_graph(SPARSE_TRAIN_N), schedule="sparse",
                          sync_interval=5)
    counts += [launches for run in ("noise_on", "noise_off")
               for launches in mlp_run[run]["launches"].values()]
    line = dict(
        phase="loop_training", arch=TRAIN_LM["arch"], nodes=TRAIN_LM["n"],
        topology="DOutGraph(4, 2)", schedule="dense", d_s=TRAIN_LM["d_s"],
        shared_leaves=leaves, shared_leaf_shapes=shapes,
        per_node_batch=TRAIN_LM["per_node_batch"],
        seq_len=TRAIN_LM["seq_len"], steps=steps, sync_interval=5,
        gamma_n=gamma_n, session_build_s=build_s,
        hooks=["LedgerHook", "BudgetHook", "MetricsHook",
               "RealSensitivityHook(chunk=1)"],
        loop=out["loop"], engine=out["engine"],
        loop_over_engine_ms_per_step=out["loop"]["ms_per_step"]
        / out["engine"]["ms_per_step"],
        state_agreement=agree, trajectory_max_abs_err=traj_err,
        ledger_accounting_equal=True, tree_checks_lm=lm_tree,
        tree_checks_mlp=mlp_tree, mlp=mlp_run)
    return line, session, batches, counts


# -- phase 23: save, restore and resume at full width -------------------------

def resume(torch, ops, session, batches, tmp: str) -> dict:
    """Phase 23. On phase 15's session cut to RESUME_LAYERS layers (the
    engine): 3 uninterrupted rounds (the state kept on the host), then 2
    rounds, ``Session.save``, ``Session.restore`` into a fresh template
    (``train_state()``) and 1 more round: the state and trajectory bit for
    bit those of the 3 rounds. The checkpoint's size and the save and load
    seconds. About 4 x 505M f32 parameters: 8.1 GB on disk and in host
    memory."""
    import os

    first, then = RESUME_SPLIT
    steps = first + then
    batch_at = lambda t: batches[t]
    ops.reset_launch_counts()
    whole = session.train(steps, batch_at)
    torch.cuda.synchronize()
    want = state_leaves(torch, whole.state, "cpu")
    want_traj = dict(whole.trajectory)
    want_t = whole.state.dpps.t
    del whole
    torch.cuda.empty_cache()
    part = session.train(first, batch_at)
    torch.cuda.synchronize()
    path = os.path.join(tmp, "state")
    t0 = time.perf_counter()
    session.save(path, part.state, step=first)
    save_s = time.perf_counter() - t0
    del part
    torch.cuda.empty_cache()
    size_gb = sum(os.path.getsize(os.path.join(path, f))
                  for f in os.listdir(path)) / 1e9
    t0 = time.perf_counter()
    restored, meta = session.restore(path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(restored.dpps.t == first and meta["step"] == first
            and isinstance(restored.dpps.t, int), "restored round counter")
    names = meta["names"]
    rest = session.train(then, batch_at, state=restored)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expected = {k: a + b + c for (k, a), b, c in zip(
        tree_launches(1, 0, steps, 5).items(),
        tree_launches(1, 0, first, 5).values(),
        tree_launches(1, first, then, 5).values())}
    require(launches == expected, f"resume launches {launches}, expected "
                                  f"{expected}")
    got = state_leaves(torch, rest.state)
    require(rest.state.dpps.t == want_t and len(got) == len(want),
            "resumed state's structure")
    equal = [bool(torch.equal(g, w.to(g.device))) for g, w in zip(got, want)]
    require(all(equal), f"resumed state differs at leaves "
                        f"{[i for i, e in enumerate(equal) if not e]}")
    for k, v in rest.trajectory.items():
        require(bool((v == want_traj[k][first:]).all()),
                f"resumed trajectory {k}: {v} != {want_traj[k][first:]}")
    del rest, restored, got, want
    torch.cuda.empty_cache()
    return dict(phase="resume", arch=TRAIN_LM["arch"], nodes=TRAIN_LM["n"],
                layers=RESUME_LAYERS, d_s=TRAIN_LM["d_s"],
                rounds_before_save=first,
                rounds_after_restore=then, checkpoint_gb=size_gb,
                save_s=save_s, load_s=load_s, leaves=len(equal),
                names_head=names[:3], names_tail=names[-3:],
                t_leaf=[n for n in names if n.endswith("/.t")],
                bit_equal_state=True, bit_equal_trajectory=True,
                launches=launches)


# -- phase 24: network faults at full width -----------------------------------

def faulted_consensus(torch, api, T, ops, ref, dev, *, topo, shape: dict,
                      schedule: str, fault_free_ms: float) -> dict:
    """``Session.run(20)`` under ``FaultModel(**FAULTS)`` over an (N, d_s)
    f32 buffer, one timed call: ms a round beside the fault-free phase's,
    the host ms of realizing each round's weights (its share of the round),
    mean(a) = 1 to 1e-5, node 4 isolated in its churn window, exact
    launches. Then the mix kernel against its plain version on one realized
    round's weights (round 6, node 4 down), over column windows:
    ``pushsum_mix`` bit for bit (N <= 32: one fma chain a column in both);
    ``spmm`` to rtol 1e-6 / atol 1e-6 (fma against a multiply and an add)
    and bit for bit against ``pushsum_mix`` on the same weights as a dense
    W."""
    from repro_torch.net import FaultModel

    n, d_s = shape["n"], shape["d_s"]
    c_prime, lam = T.calibrate_constants(topo)
    gamma_n = 0.5 * (1.0 / lam - 1.0) / (2.0 * c_prime * d_s)
    session = api.Session.build(topo, privacy=api.PrivacySpec(
        b=1.0, gamma_n=gamma_n, c_prime=c_prime, lam=lam), schedule=schedule,
        seed=SEED, faults=FaultModel(**FAULTS))
    plan = session.plan
    require(plan.dynamic and plan.use_kernels
            and plan.schedule == ("sparse" if schedule == "sparse"
                                  else "dynamic"), f"plan {plan.schedule}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    values = {"shared": torch.randn((n, d_s), generator=gen, device=dev)}
    session.run(2, values=values)                   # warms the allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = session.run(CONSENSUS_ROUNDS, values=values)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mix = "spmm" if schedule == "sparse" else "pushsum_mix"
    expected = {k: 0 for k in KERNELS}
    expected.update(l1_norm_rows=CONSENSUS_ROUNDS + 1,
                    dpps_perturb_rows=CONSENSUS_ROUNDS,
                    **{mix: CONSENSUS_ROUNDS})
    require(launches == expected, f"launches {launches}, expected {expected}")
    a = rep.state.push.a
    a_mean = a.double().mean().item()
    require(abs(a_mean - 1.0) < 1e-5 and bool((a > 0).all()),
            f"mean(a) = {a_mean}")
    require(bool(torch.isfinite(rep.state.push.s["shared"]).all()),
            "state not finite")
    traj = rep.trajectory
    down = traj["net_out_degree"][5:12, 4]
    require(bool((down == 0).all()) and int(traj["net_out_degree"][4, 4]) > 0,
            f"churn: node 4's degrees {traj['net_out_degree'][:, 4]}")
    dropped = [int(x) for x in traj["net_dropped_edges"]]
    require(sum(dropped) > 0, "no edge dropped")
    del rep
    torch.cuda.empty_cache()

    realize_ms = []
    for t in range(CONSENSUS_ROUNDS):
        kwargs = plan.mix_at(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if schedule == "sparse":
            plan.faults.realize_sparse(kwargs["sparse_idx"],
                                       kwargs["sparse_vals"], t, seed=SEED)
        else:
            plan.faults.realize(kwargs["w"], t, seed=SEED)
        torch.cuda.synchronize()
        realize_ms.append((time.perf_counter() - t0) * 1e3)
    ms_per_round = run_ms / CONSENSUS_ROUNDS
    realize_mean = sum(realize_ms) / len(realize_ms)

    kwargs = plan.mix_at(6)
    buf = values["shared"]
    if schedule == "sparse":
        idx = kwargs["sparse_idx"]
        vals, _ = plan.faults.realize_sparse(idx, kwargs["sparse_vals"], 6,
                                             seed=SEED)
        w = torch.zeros((n, n), device=dev).index_put_(
            (torch.arange(n, device=dev)[:, None].expand_as(idx),
             idx.long()), vals, accumulate=True)
        out = ops.spmm(idx, vals, buf)
        plain = lambda c0, c1: ref.spmm(idx, vals, buf[:, c0:c1])
        tol = (1e-6, 1e-6)
    else:
        w, _ = plan.faults.realize(kwargs["w"], 6, seed=SEED)
        out = ops.pushsum_mix(w, buf)
        plain = lambda c0, c1: ref.pushsum_mix(w, buf[:, c0:c1].contiguous())
        tol = (0.0, 0.0)
    require(bool((w[:, 4] == torch.eye(n, device=dev)[:, 4]).all()),
            "node 4 is not isolated in round 6's realized weights")
    worst, ok, bit = [0.0], [True], [True]

    def check(c0, c1, want):
        err, good = compare(out[:, c0:c1], want, *tol)
        worst[0] = max(worst[0], err)
        ok[0] = ok[0] and good
        bit[0] = bit[0] and bool(torch.equal(out[:, c0:c1], want))

    plain_ms = timed_windows(torch, plain, check, d_s, 1 << 24)
    require(ok[0] and (schedule == "sparse" or bit[0]),
            f"{mix} off its plain version on realized weights: {worst[0]}")
    line = dict(n=n, d_s=d_s, topology=type(topo).__name__,
                schedule=plan.schedule, faults=FAULTS, rounds=CONSENSUS_ROUNDS,
                gamma_n=gamma_n, run_ms=run_ms, ms_per_round=ms_per_round,
                fault_free_ms_per_round=fault_free_ms,
                over_fault_free=ms_per_round / fault_free_ms,
                realize_host_ms=realize_ms, realize_host_ms_mean=realize_mean,
                realize_share_of_round=realize_mean / ms_per_round,
                a_mean=a_mean, dropped_edges=dropped,
                node4_out_degree=[int(x) for x in
                                  traj["net_out_degree"][:, 4]],
                peak_mem_gb=peak_gb, launches=launches,
                realized_mix=dict(kernel=mix, max_abs_err=worst[0],
                                  bit_equal_plain=bit[0], rtol=tol[0],
                                  atol=tol[1], plain_ms_windows=plain_ms))
    if schedule == "sparse":
        same = [True]

        def check_dense(c0, c1, want):
            same[0] = same[0] and bool(torch.equal(out[:, c0:c1], want))

        timed_windows(torch, lambda c0, c1: ops.pushsum_mix(
            w, buf[:, c0:c1].contiguous()), check_dense, d_s, 1 << 24)
        require(same[0], "spmm off pushsum_mix on the realized weights")
        line["realized_mix"]["bit_equal_pushsum_mix"] = True
    del out, values, buf
    torch.cuda.empty_cache()
    return line


def faulted_training(torch, api, T, ops) -> dict:
    """Phase 15's session (llama3.2-1b full width, N = 4) built with
    ``FaultModel(**FAULTS_TRAIN)`` (the "dynamic" schedule), trained 3 steps
    under a ``LedgerHook`` and a ``NetworkStatsHook``: ms a step, peak
    memory, exact launches, the ledger's realized out-degrees and the
    network summary."""
    from repro_torch.net import FaultModel, NetworkStatsHook

    session, batches, gamma_n = lm_session(
        torch, T, faults=FaultModel(**FAULTS_TRAIN))
    require(session.plan.schedule == "dynamic", session.plan.schedule)
    steps = LOOP_STEPS
    hooks = [api.LedgerHook(), NetworkStatsHook()]
    events = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep, step_ms = timed_train(torch, session, batches, steps, events,
                               hooks=hooks)
    launches = ops.launch_counts()
    want = tree_launches(1, 0, steps, 5)
    require(launches == want, f"launches {launches}, expected {want}")
    loss = [float(x) for x in rep.trajectory["loss_mean"]]
    require(all(math.isfinite(x) for x in loss), f"losses {loss}")
    a_mean = rep.state.dpps.push.a.double().mean().item()
    require(abs(a_mean - 1.0) < 1e-5, f"mean(a) = {a_mean}")
    entries = hooks[0].ledger.entries
    degrees = [dict(round=e["round"], out_degree_min=e["out_degree_min"],
                    out_degree_mean=e["out_degree_mean"],
                    dropped_edges=e["dropped_edges"]) for e in entries]
    require(len(degrees) == steps, f"ledger {entries}")
    network = rep.network.summary()
    dpps_ms = [a.elapsed_time(b) for a, b, _ in events["dpps_step"]]
    line = dict(arch=TRAIN_LM["arch"], nodes=TRAIN_LM["n"],
                d_s=TRAIN_LM["d_s"], faults=FAULTS_TRAIN, steps=steps,
                gamma_n=gamma_n, step_ms=step_ms,
                ms_per_step=sum(step_ms[1:]) / (steps - 1),
                dpps_round_ms=dpps_ms,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                losses=loss, a_mean=a_mean, launches=launches,
                ledger_degrees=degrees, network=network)
    del rep, session, batches
    torch.cuda.empty_cache()
    return line


NOISE_ROWS = ("sensitivity_used", "sensitivity_estimate",
              "sensitivity_local", "eps_l1_max", "noise_l1_mean")


def mlp_drivers(torch, api, mlp, data, ops, dev, *, topo, schedule: str,
                faults=None, delays=None, sync_interval: int,
                pair=("loop", "engine")) -> dict:
    """The paper MLP (partpsp-2) ``LOOP_MLP_STEPS`` steps on ``topo``
    under the fault and delay models (kwargs dicts), by the two runs of
    ``pair`` ("loop": the per-round driver; "engine"; "pytree": the engine
    with ``packed=False``), noise on and off, with exact launches (a leaf a
    launch for the loop and the pytree runtime; ``B + 1`` mixes a round a
    buffer under delays). Noise on: every ``net_*`` and ``async_*`` row,
    ``a`` and the losses bit for bit, the state to rtol 1e-4 (the norms sum
    a leaf at a time against once over the buffer, so a sensitivity can
    differ by an ulp). Noise off: the state and every row but the norms'
    bit for bit."""
    from repro_torch.net import DelayModel, FaultModel

    n, steps = topo.n_nodes, LOOP_MLP_STEPS
    batches = training_batches(mlp, data, torch, n, steps)
    on = [tuple(x.to(dev) for x in b) for b in batches]
    params = mlp.init_mlp(torch.Generator().manual_seed(SEED))
    mix = "spmm" if schedule == "sparse" else "pushsum_mix"
    b = 0 if delays is None else delays["max_delay"]
    out = {}
    for noise in (True, False):
        reps = {}
        for run in pair:
            session = api.Session.build(
                topo, privacy=api.PrivacySpec(b=1.0, gamma_n=1e-5,
                                              noise=noise, c_prime=0.8,
                                              lam=0.6),
                model=mlp.mlp_loss, params=params,
                partition=mlp.PARTITIONS["partpsp-2"], algorithm="partpsp",
                gamma_l=0.1, gamma_s=0.1, clip=100.0, schedule=schedule,
                sync_interval=sync_interval, seed=SEED,
                packed=run != "pytree",
                faults=FaultModel(**faults) if faults else None,
                delays=DelayModel(**delays) if delays else None)
            leaves = len(session.train_state().dpps.push.s)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            rep = session.train(steps, lambda t: on[t],
                                driver="loop" if run == "loop" else "engine")
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
            launches = ops.launch_counts()
            per = 1 if run == "engine" else leaves
            want = {k: 0 for k in KERNELS}
            want.update(
                l1_norm_rows=per * (steps + 1),
                dpps_perturb_rows=per * steps if noise else 0,
                **{mix: per * (b + 1) * sum(
                    (t + 1) % sync_interval != 0 if sync_interval else True
                    for t in range(steps))})
            require(launches == want, f"MLP {run} noise={noise}: launches "
                                      f"{launches}, expected {want}")
            reps[run] = (rep, ms, launches)
        (r0, ms0, l0), (r1, ms1, l1) = reps[pair[0]], reps[pair[1]]
        s0, s1 = state_leaves(torch, r0.state), state_leaves(torch, r1.state)
        a_equal = bool(torch.equal(r0.state.dpps.push.a,
                                   r1.state.dpps.push.a))
        state_bit = all(bool(torch.equal(x, y)) for x, y in zip(s0, s1))
        agree = states_agree(torch, s0, s1)
        draws_rows = [k for k in r0.trajectory
                      if k.startswith(("net_", "async_")) or k in (
                          "a_min", "a_max")]
        rows_bit = {k: bool((r0.trajectory[k] == r1.trajectory[k]).all())
                    for k in r0.trajectory}
        require(a_equal and all(rows_bit[k] for k in draws_rows)
                and rows_bit["loss_mean"],
                f"MLP {pair} noise={noise}: masks / a / losses differ: "
                f"{rows_bit}")
        require(not agree["off"], f"MLP {pair} noise={noise}: {agree}")
        if not noise:
            require(state_bit and all(v for k, v in rows_bit.items()
                                      if k not in NOISE_ROWS),
                    f"MLP {pair} noise off: not bit for bit: {rows_bit}")
        if delays is not None:
            mass = r1.trajectory["async_mass_mean"]
            require(bool((abs(mass - 1.0) <= 1e-5).all()), f"mass {mass}")
            require(int(r1.trajectory["async_staleness_max"].max()) <= b,
                    "staleness over B")
        out["noise_on" if noise else "noise_off"] = dict(
            ms_per_step={pair[0]: ms0, pair[1]: ms1},
            launches={pair[0]: l0, pair[1]: l1}, a_bit_equal=a_equal,
            draw_rows_bit_equal=draws_rows + ["loss_mean"],
            state_bit_equal=state_bit,
            state=agree,
            dropped_edges=(int(r1.trajectory["net_dropped_edges"].sum())
                           if "net_dropped_edges" in r1.trajectory else None))
        del reps, r0, r1
    return dict(n=n, topology=type(topo).__name__, schedule=schedule,
                partition="partpsp-2", steps=steps, faults=faults,
                delays=delays, sync_interval=sync_interval, pair=list(pair),
                **out)


def faults_phase(torch, api, mlp, data, ops, ref, T, dev, *,
                 dense_ms: float, sparse_ms: float) -> tuple[dict, list]:
    """Phase 24: (a) the dense full width (N = 5) and (b) the sparse full
    width (ER(24)) under faults, (c) llama3.2-1b's training under faults,
    (d) the paper MLP on ER(128), dense and sparse, loop against engine.
    Returns (line, launch counts of each run)."""
    counts = []
    dense = faulted_consensus(torch, api, T, ops, ref, dev,
                              topo=T.DOutGraph(FULL["n"], 2), shape=FULL,
                              schedule="dense", fault_free_ms=dense_ms)
    counts.append(dense["launches"])
    sparse = faulted_consensus(torch, api, T, ops, ref, dev,
                               topo=sparse_graph(SPARSE_FULL["n"]),
                               shape=SPARSE_FULL, schedule="sparse",
                               fault_free_ms=sparse_ms)
    counts.append(sparse["launches"])
    trained = faulted_training(torch, api, T, ops)
    counts.append(trained["launches"])
    mlps = {}
    for schedule in ("dense", "sparse"):
        mlps[schedule] = mlp_drivers(
            torch, api, mlp, data, ops, dev,
            topo=sparse_graph(SPARSE_TRAIN_N), schedule=schedule,
            faults=FAULTS, sync_interval=5)
        for noise in ("noise_on", "noise_off"):
            counts += list(mlps[schedule][noise]["launches"].values())
    return dict(phase="faults", dense_full=dense, sparse_full=sparse,
                training=trained, mlp=mlps), counts


# -- phase 25: bounded-delay async push-sum at full width ----------------------

def async_consensus(torch, api, T, ops, dev) -> dict:
    """DPPS consensus over llama3.2-1b's shared width (N = 4, d_s =
    243,286,016: one buffer 3.89 GB) on 2-out, dense schedule,
    ``DelayModel(**DELAYS)`` with ``drop_rate=0.1``, ``ASYNC_ROUNDS``
    rounds in one timed call: ms a round, peak memory beside its
    reckoning, the mix launched B + 1 times a round, mass and staleness."""
    from repro_torch.net import DelayModel, FaultModel

    n, d_s = TRAIN_FULL["n"], TRAIN_FULL["d_s"]
    topo = T.DOutGraph(n, 2)
    c_prime, lam = T.calibrate_constants(topo)
    gamma_n = 0.5 * (1.0 / lam - 1.0) / (2.0 * c_prime * d_s)
    delays = DelayModel(**DELAYS)
    session = api.Session.build(topo, privacy=api.PrivacySpec(
        b=1.0, gamma_n=gamma_n, c_prime=c_prime, lam=lam), schedule="dense",
        sync_interval=0, seed=SEED, delays=delays,
        faults=FaultModel(drop_rate=0.1))
    require(session.plan.delays is delays and session.plan.dynamic,
            "plan")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    values = {"shared": torch.randn((n, d_s), generator=gen, device=dev)}
    buffer_gb = n * d_pad_of(d_s) * 4 / 1e9
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = session.run(ASYNC_ROUNDS, values=values)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = ops.launch_counts()
    b = delays.max_delay
    expected = {k: 0 for k in KERNELS}
    expected.update(l1_norm_rows=ASYNC_ROUNDS + 1,
                    dpps_perturb_rows=ASYNC_ROUNDS,
                    pushsum_mix=(b + 1) * ASYNC_ROUNDS)
    require(launches == expected, f"launches {launches}, expected {expected}")
    traj = rep.trajectory
    mass = [float(x) for x in traj["async_mass_mean"]]
    require(all(abs(x - 1.0) <= 1e-5 for x in mass), f"mass {mass}")
    stale = int(traj["async_staleness_max"].max())
    require(stale <= b, f"staleness {stale}")
    require(all(bool(torch.isfinite(x).all()) for x in
                (rep.state.push.s["shared"], rep.state.mail.cal_s["shared"],
                 rep.state.mail.inbox_s["shared"])), "state not finite")
    reckoned = 3 + (b + 1) + 1 + 1 + 1 + b + 1
    require(peak_gb <= base_gb + (reckoned - 0.5) * buffer_gb,
            f"peak {peak_gb} GB over the reckoned {reckoned} buffers")
    line = dict(n=n, d_s=d_s, buffer_gb=buffer_gb, topology="DOutGraph(4, 2)",
                schedule="dense", delays=dict(DELAYS, rates=list(
                    DELAYS["rates"])), faults=dict(drop_rate=0.1),
                rounds=ASYNC_ROUNDS, gamma_n=gamma_n, run_ms=run_ms,
                ms_per_round=run_ms / ASYNC_ROUNDS,
                allocated_before_gb=base_gb, peak_mem_gb=peak_gb,
                # live buffers at a round's peak: the caller's values, the
                # state, the zero perturbation, the incoming mailbox (B
                # calendar slots and the inbox), the noised payload, the
                # arrivals, the new state, the new calendar (B) and one
                # slot's mix output
                peak_reckoned_buffers=reckoned,
                peak_reckoned_gb=reckoned * buffer_gb,
                reference_step_leaf_buffers=17,
                reference_reckoned_gb=17 * buffer_gb,
                dense_full_width_note=(
                    "the dense full width (N = 5, d_s = 505,956,352: 10.1 GB "
                    "a buffer) needs about 12 such buffers with a B = 2 "
                    "mailbox, 121 GB: more than the card holds; phase 25 "
                    "runs llama3.2-1b's shared width instead"),
                async_mass_mean=mass,
                staleness_max=[int(x) for x in traj["async_staleness_max"]],
                timeouts=[int(x) for x in traj["async_timeouts"]],
                active=[int(x) for x in traj["async_active"]],
                delay_hist=[[int(v) for v in row]
                            for row in traj["async_delay_hist"]],
                launches=launches)
    del rep, values
    torch.cuda.empty_cache()
    return line


def async_resume(torch, api, mlp, data, ops, dev, tmp: str) -> dict:
    """Phase 25c: the paper MLP on ER(128), sparse schedule, delays and
    faults, packed engine: 2 rounds, ``Session.save`` (the mailbox among
    the leaves), ``Session.restore`` into a fresh template, 1 more round,
    bit for bit 3 uninterrupted rounds."""
    import os

    from repro_torch.net import DelayModel, FaultModel

    first, then = RESUME_SPLIT
    topo = sparse_graph(SPARSE_TRAIN_N)
    batches = training_batches(mlp, data, torch, topo.n_nodes, first + then)
    on = [tuple(x.to(dev) for x in b) for b in batches]
    session = api.Session.build(
        topo, privacy=api.PrivacySpec(b=1.0, gamma_n=1e-5, c_prime=0.8,
                                      lam=0.6),
        model=mlp.mlp_loss, params=mlp.init_mlp(
            torch.Generator().manual_seed(SEED)),
        partition=mlp.PARTITIONS["partpsp-2"], algorithm="partpsp",
        gamma_l=0.1, gamma_s=0.1, clip=100.0, schedule="sparse",
        sync_interval=0, seed=SEED, delays=DelayModel(**ASYNC_MLP),
        faults=FaultModel(**FAULTS))
    batch_at = lambda t: on[t]
    ops.reset_launch_counts()
    whole = session.train(first + then, batch_at)
    part = session.train(first, batch_at)
    path = os.path.join(tmp, "async_state")
    session.save(path, part.state, step=first)
    restored, meta = session.restore(path)
    require(restored.dpps.t == first, "restored counter")
    rest = session.train(then, batch_at, state=restored, start=first)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    got, want = state_leaves(torch, rest.state), state_leaves(torch,
                                                             whole.state)
    equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
    require(len(got) == len(want) and all(equal),
            f"resumed async state differs at {equal}")
    for k, v in rest.trajectory.items():
        require(bool((v == whole.trajectory[k][first:]).all()),
                f"resumed trajectory {k}")
    mail = [x for x in meta["names"] if x.startswith(".dpps/.mail/")]
    require(len(mail) == 6, f"mailbox leaves {mail}")
    return dict(n=topo.n_nodes, rounds_before_save=first,
                rounds_after_restore=then, leaves=len(equal),
                mailbox_names=mail, bit_equal_state=True,
                bit_equal_trajectory=True, launches=launches)


def async_phase(torch, api, mlp, data, ops, T, dev,
                tmp: str) -> tuple[dict, list]:
    """Phase 25: (a) async consensus at llama3.2-1b's shared width; (b) the
    paper MLP on ER(128), sparse schedule, delays and faults: loop against
    engine and packed against pytree; (c) save, restore and resume."""
    counts = []
    cons = async_consensus(torch, api, T, ops, dev)
    counts.append(cons["launches"])
    topo = sparse_graph(SPARSE_TRAIN_N)
    mlps = {}
    for pair in (("loop", "engine"), ("pytree", "engine")):
        key = "_against_".join(pair)
        mlps[key] = mlp_drivers(torch, api, mlp, data, ops, dev, topo=topo,
                                schedule="sparse", faults=FAULTS,
                                delays=ASYNC_MLP, sync_interval=0, pair=pair)
        mlps[key]["delays"] = dict(ASYNC_MLP, rates="(1, 2, 1, 1) x 32")
        for noise in ("noise_on", "noise_off"):
            counts += list(mlps[key][noise]["launches"].values())
    resumed = async_resume(torch, api, mlp, data, ops, dev, tmp)
    counts.append(resumed["launches"])
    return dict(phase="async", consensus=cons, mlp=mlps,
                resume=resumed), counts


# -- phase 26: the wire codecs ------------------------------------------------

WIRE_FULL_SPECS = ("int8", "bf16")
# 26a's rounds at the dense full width: half of CONSENSUS_ROUNDS, for the
# script's time limit with phase 34 (int8's eager Philox draw takes ~1 s a
# round)
WIRE_ROUNDS = 10
TOPK_SPEC = "topk:1/16"
WIRE_AGREE_STEPS = 10
# temporaries a full-width round adds to phase 3's five (N, d_pad) buffers,
# in f32 (N, 2^24) windows: int8 the Philox draw (its four int64 word
# tensors and their stack, 2 windows each, the shifted words, the uniforms;
# about 12 at once, counted generously) with the divided window; bf16 the
# bf16 window of the in-place rounding (the plain mix writes phase 3's mix
# output)
WIRE_WINDOW_BUFFERS = {"int8": 12, "bf16": 0.5}


def wire_consensus(torch, api, T, ops, dev, spec: str, f32_ms: float) -> dict:
    """``run(WIRE_ROUNDS)`` of DPPS consensus at the dense full width
    (N = 5, d_s = 505,956,352, 2-out) under the codec ``spec``, in one timed
    call: ms a round beside phase 3's raw f32 round, peak memory beside
    its reckoning, the launches (a bf16 round launches no mix), mean(a);
    int8 also the time of one round's stochastic-rounding draw and of its
    encode alone."""
    from repro_torch.core.pushsum import consensus_error
    from repro_torch.wire import DRAW_COLUMNS, parse_wire_spec, wire_uniforms

    n, d_s = FULL["n"], FULL["d_s"]
    topo = T.DOutGraph(n, 2)
    c_prime, lam = T.calibrate_constants(topo)
    gamma_n = 0.5 * (1.0 / lam - 1.0) / (2.0 * c_prime * d_s)
    codec = parse_wire_spec(spec)
    session = api.Session.build(topo, privacy=api.PrivacySpec(
        b=1.0, gamma_n=gamma_n, c_prime=c_prime, lam=lam), schedule="dense",
        seed=SEED, wire=codec)
    require(session.plan.use_kernels and session.plan.wire == codec, "plan")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    values = {"shared": torch.randn((n, d_s), generator=gen, device=dev)}
    err0 = consensus_error(values["shared"], chunk=1 << 24).item()
    buffer_gb = n * d_pad_of(d_s) * 4 / 1e9
    window_gb = n * DRAW_COLUMNS * 4 / 1e9
    torch.cuda.synchronize()
    base_gb = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = session.run(WIRE_ROUNDS, values=values)
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = ops.launch_counts()
    expected = {k: 0 for k in KERNELS}
    expected.update(l1_norm_rows=WIRE_ROUNDS + 1,
                    dpps_perturb_rows=WIRE_ROUNDS,
                    pushsum_mix=0 if spec == "bf16" else WIRE_ROUNDS)
    require(launches == expected, f"{spec} launches {launches}, expected "
                                  f"{expected}")
    state = rep.state
    a_mean = state.push.a.double().mean().item()
    require(abs(a_mean - 1.0) < 1e-5, f"{spec}: mean(a) = {a_mean}")
    require(bool(torch.isfinite(state.push.s["shared"]).all()),
            f"{spec}: state not finite")
    err = consensus_error(state.push.s["shared"], a=state.push.a,
                          chunk=1 << 24).item()
    # phase 3's five buffers (the values, the zero perturbation, the state,
    # the noised buffer, the mix output) and the codec's window temporaries
    reckoned_gb = 5 * buffer_gb + WIRE_WINDOW_BUFFERS[spec] * window_gb
    require(peak_gb <= base_gb + reckoned_gb - buffer_gb + 0.5,
            f"{spec}: peak {peak_gb} GB over the reckoned {reckoned_gb}")
    line = dict(spec=spec, n=n, d_s=d_s, buffer_gb=buffer_gb,
                topology="DOutGraph(5, 2)", rounds=WIRE_ROUNDS,
                gamma_n=gamma_n, run_ms=run_ms,
                ms_per_round=run_ms / WIRE_ROUNDS,
                f32_ms_per_round_phase3=f32_ms,
                consensus_error_initial=err0, consensus_error_final=err,
                a_mean=a_mean, allocated_before_gb=base_gb,
                peak_mem_gb=peak_gb, peak_reckoned_gb=reckoned_gb,
                payload_bytes=codec.payload_bytes(d_s),
                compression_ratio=4.0 * d_s / codec.payload_bytes(d_s),
                launches=launches)
    del rep, state
    if spec == "int8":
        # one round's draw alone (the encode's windows), then the encode
        wire = values["shared"]
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for c0 in range(0, d_s, DRAW_COLUMNS):
            wire_uniforms(SEED, 0, n, c0, min(c0 + DRAW_COLUMNS, d_s),
                          device=dev)
        end.record()
        torch.cuda.synchronize()
        line["draw_ms"] = start.elapsed_time(end)
        out = torch.empty_like(wire)
        start.record()
        codec.encode(wire, (), seed=SEED, t=0, out=out)
        end.record()
        torch.cuda.synchronize()
        line["encode_ms"] = start.elapsed_time(end)
        del out
    del values
    torch.cuda.empty_cache()
    return line


# The share of entries that may sit a quantum apart between the card and
# the CPU after phase 26b's consensus rounds.
WIRE_OFF_LIMIT = {"int8": 0.0, "bf16": 1e-3}


def wire_agreement(torch, api, T, dev) -> dict:
    """Seeded consensus under each codec on the card and on the CPU (the
    same noise bits and int8 uniforms: counter-based Philox): the state to
    rtol 1e-5 plus 1e-6 of its largest magnitude, except entries where the
    card's logf (an ulp from the CPU's log) or the kernels' summation order
    moved a value across a rounding boundary, one quantum apart (int8
    max|s| / 127, bf16 max|s| 2^-8). Those are counted and bounded
    (:data:`WIRE_OFF_LIMIT`: none for int8, 0.1 % of the entries for bf16).
    Top-k has no rounding: it must agree everywhere."""
    from repro_torch.wire import parse_wire_spec

    n, d_s = 10, 7840
    vals = torch.randn((n, d_s), generator=torch.Generator().manual_seed(2))
    out = {}
    for spec in ("int8", "bf16", TOPK_SPEC):
        states = {}
        for device in ("cuda", "cpu"):
            session = api.Session.build(
                T.DOutGraph(n, 2), privacy=api.PrivacySpec(
                    b=1.0, gamma_n=1e-6, c_prime=0.8, lam=0.6),
                schedule="dense", sync_interval=5, chunk=4, seed=SEED,
                device=device, wire=parse_wire_spec(spec))
            rep = session.run(7, values={"x": vals})
            states[device] = rep.state.push.s["x"].cpu()
        got, want = states["cuda"], states["cpu"]
        diff = (got - want).abs()
        lim = 1e-5 * want.abs() + 1e-6 * want.abs().max()
        off = int((diff > lim).sum())
        quantum = {"int8": 1.0 / 127.0, "bf16": 2.0 ** -8}.get(
            spec, 0.0) * float(want.abs().max())
        limit = int(WIRE_OFF_LIMIT.get(spec, 0.0) * diff.numel())
        require(off <= limit, f"{spec}: card against CPU off at {off} "
                              f"entries (at most {limit})")
        require(bool((diff <= lim + quantum).all()),
                f"{spec}: card against CPU beyond a quantum: "
                f"{diff.max().item()}")
        out[spec] = dict(max_abs_err=diff.max().item(), entries=diff.numel(),
                         quantum=quantum, off_by_a_quantum=off,
                         off_limit=limit)
    return dict(n=n, d_s=d_s, rounds=7, results=out)


def wire_training_agreement(torch, api, mlp, data) -> dict:
    """The paper MLP (partpsp-1, 2-out, N = 10) trained ``WIRE_AGREE_STEPS``
    steps under int8 and under top-k on the card and on the CPU (the same
    Philox streams): the losses to 1e-3 relative, as phase 8 holds
    training; int8 entries of the shared state a quantum apart counted."""
    from repro_torch.core.topology import DOutGraph
    from repro_torch.wire import parse_wire_spec

    n, steps = PAPER["n"], WIRE_AGREE_STEPS
    batches = training_batches(mlp, data, torch, n, steps)
    out = {}
    for spec in ("int8", TOPK_SPEC):
        reps = {}
        for device in ("cuda", "cpu"):
            session = api.Session.build(
                DOutGraph(n, 2), privacy=api.PrivacySpec(
                    b=1.0, gamma_n=1e-5, c_prime=0.8, lam=0.6),
                model=mlp.mlp_loss, params=mlp.init_mlp(
                    torch.Generator().manual_seed(SEED)),
                partition=mlp.PARTITIONS["partpsp-1"], algorithm="partpsp",
                gamma_l=0.1, gamma_s=0.1, clip=100.0, schedule="dense",
                sync_interval=5, seed=SEED, device=device,
                wire=parse_wire_spec(spec))
            on = [tuple(x.to(session.device) for x in b) for b in batches]
            reps[device] = session.train(steps, lambda t: on[t])
        gpu = reps["cuda"].trajectory["loss_mean"]
        cpu = reps["cpu"].trajectory["loss_mean"]
        rel = float(abs(gpu - cpu).max() / abs(cpu).max())
        require(rel < 1e-3, f"{spec} training on the card vs CPU: {rel}")
        got = reps["cuda"].state.dpps.push.s[0].cpu()
        want = reps["cpu"].state.dpps.push.s[0]
        diff = (got - want).abs()
        off = int((diff > 1e-5 * want.abs()
                   + 1e-6 * want.abs().max()).sum())
        out[spec] = dict(loss_max_rel_diff=rel,
                         shared_max_abs_err=diff.max().item(),
                         shared_entries=diff.numel(), shared_off=off)
    return dict(n=n, steps=steps, results=out)


def topk_training(torch, api, mlp, data, ops, dev, *, topo,
                  schedule: str) -> dict:
    """The paper MLP (partpsp-1, d_s = 7840) ``TRAIN_STEPS`` steps under
    top-k (1/16, error feedback) on ``topo``: the losses fall, the exact
    launches, the residual's mean L1 bounded, the compression ratio."""
    from repro_torch.wire import parse_wire_spec

    n = topo.n_nodes
    batches = training_batches(mlp, data, torch, n, TRAIN_STEPS)
    on = [tuple(x.to(dev) for x in b) for b in batches]
    codec = parse_wire_spec(TOPK_SPEC)
    session = api.Session.build(
        topo, privacy=api.PrivacySpec(b=1.0, gamma_n=1e-5, c_prime=0.8,
                                      lam=0.6),
        model=mlp.mlp_loss, params=mlp.init_mlp(
            torch.Generator().manual_seed(SEED)),
        partition=mlp.PARTITIONS["partpsp-1"], algorithm="partpsp",
        gamma_l=0.1, gamma_s=0.1, clip=100.0, schedule=schedule,
        sync_interval=5, seed=SEED, wire=codec)
    d_s = session.partition.d_shared()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    class WireStats(api.RoundHook):  # asks the rounds for wd_wire_resid
        needs_wire_stats = True

    rep = session.train(TRAIN_STEPS, lambda t: on[t], hooks=[WireStats()])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    launches = ops.launch_counts()
    mix = "spmm" if schedule == "sparse" else "pushsum_mix"
    want = tree_launches(1, 0, TRAIN_STEPS, 5, mix=mix)
    require(launches == want, f"top-k {schedule}: launches {launches}, "
                              f"expected {want}")
    loss = rep.trajectory["loss_mean"]
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    require(all(math.isfinite(float(x)) for x in loss) and last < first,
            f"top-k {schedule}: loss {first} -> {last}")
    resid = [float(x) for x in rep.trajectory["wd_wire_resid"]]
    require(all(math.isfinite(x) for x in resid), "residual not finite")
    a_mean = rep.state.dpps.push.a.double().mean().item()
    require(abs(a_mean - 1.0) < 1e-5, f"mean(a) = {a_mean}")
    return dict(n=n, topology=type(topo).__name__, schedule=schedule,
                spec=TOPK_SPEC, d_s=d_s, k=codec.effective_k(d_s),
                steps=TRAIN_STEPS, ms_per_step=ms, loss_first10=first,
                loss_last10=last, wire_resid_l1_first=resid[0],
                wire_resid_l1_max=max(resid), wire_resid_l1_last=resid[-1],
                a_mean=a_mean, payload_bytes=codec.payload_bytes(d_s),
                compression_ratio=4.0 * d_s / codec.payload_bytes(d_s),
                launches=launches)


def int8_async(torch, api, mlp, data, ops, dev) -> dict:
    """int8 under delays on ER(128) (sparse, the MLP, ``ASYNC_MLP`` with
    drop 0.2): the noised payload is encoded before it is enqueued; mass
    conserved, staleness <= B, B + 1 spmm launches a round."""
    from repro_torch.net import DelayModel, FaultModel
    from repro_torch.wire import Int8StochasticCodec

    topo = sparse_graph(SPARSE_TRAIN_N)
    steps = LOOP_MLP_STEPS
    batches = training_batches(mlp, data, torch, topo.n_nodes, steps)
    on = [tuple(x.to(dev) for x in b) for b in batches]
    session = api.Session.build(
        topo, privacy=api.PrivacySpec(b=1.0, gamma_n=1e-5, c_prime=0.8,
                                      lam=0.6),
        model=mlp.mlp_loss, params=mlp.init_mlp(
            torch.Generator().manual_seed(SEED)),
        partition=mlp.PARTITIONS["partpsp-2"], algorithm="partpsp",
        gamma_l=0.1, gamma_s=0.1, clip=100.0, schedule="sparse",
        sync_interval=0, seed=SEED, delays=DelayModel(**ASYNC_MLP),
        faults=FaultModel(drop_rate=0.2), wire=Int8StochasticCodec())
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rep = session.train(steps, lambda t: on[t])
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    b = ASYNC_MLP["max_delay"]
    want = {k: 0 for k in KERNELS}
    want.update(l1_norm_rows=steps + 1, dpps_perturb_rows=steps,
                spmm=(b + 1) * steps)
    require(launches == want, f"int8 async launches {launches}, expected "
                              f"{want}")
    mass = rep.trajectory["async_mass_mean"]
    require(bool((abs(mass - 1.0) <= 1e-5).all()), f"mass {mass}")
    stale = int(rep.trajectory["async_staleness_max"].max())
    require(stale <= b, f"staleness {stale}")
    loss = [float(x) for x in rep.trajectory["loss_mean"]]
    require(all(math.isfinite(x) for x in loss), f"losses {loss}")
    return dict(n=topo.n_nodes, schedule="sparse", steps=steps,
                delays=dict(ASYNC_MLP, rates="(1, 2, 1, 1) x 32"),
                faults=dict(drop_rate=0.2), spec="int8",
                async_mass_mean=[float(x) for x in mass],
                staleness_max=stale, losses=loss, launches=launches)


def topk_resume(torch, api, mlp, data, ops, dev, tmp: str) -> dict:
    """Top-k on the MLP (2-out, N = 10, dense): 2 rounds, ``Session.save``
    (the residual as ``.dpps/.resid``), ``Session.restore``, 1 more round:
    bit for bit 3 uninterrupted rounds, residual included."""
    import os

    from repro_torch.core.topology import DOutGraph
    from repro_torch.wire import parse_wire_spec

    first, then = RESUME_SPLIT
    n = PAPER["n"]
    batches = training_batches(mlp, data, torch, n, first + then)
    on = [tuple(x.to(dev) for x in b) for b in batches]
    session = api.Session.build(
        DOutGraph(n, 2), privacy=api.PrivacySpec(b=1.0, gamma_n=1e-5,
                                                 c_prime=0.8, lam=0.6),
        model=mlp.mlp_loss, params=mlp.init_mlp(
            torch.Generator().manual_seed(SEED)),
        partition=mlp.PARTITIONS["partpsp-1"], algorithm="partpsp",
        gamma_l=0.1, gamma_s=0.1, clip=100.0, schedule="dense",
        sync_interval=5, seed=SEED, wire=parse_wire_spec(TOPK_SPEC))
    batch_at = lambda t: on[t]
    ops.reset_launch_counts()
    whole = session.train(first + then, batch_at)
    part = session.train(first, batch_at)
    path = os.path.join(tmp, "topk_state")
    session.save(path, part.state, step=first)
    restored, meta = session.restore(path)
    require(restored.dpps.t == first, "restored counter")
    rest = session.train(then, batch_at, state=restored, start=first)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    got, want = state_leaves(torch, rest.state), state_leaves(torch,
                                                             whole.state)
    equal = [bool(torch.equal(g, w)) for g, w in zip(got, want)]
    require(len(got) == len(want) and all(equal),
            f"resumed top-k state differs at {equal}")
    for k, v in rest.trajectory.items():
        require(bool((v == whole.trajectory[k][first:]).all()),
                f"resumed trajectory {k}")
    require(".dpps/.resid" in meta["names"], f"names {meta['names']}")
    require(float(rest.state.dpps.resid.abs().sum()) > 0, "empty residual")
    return dict(n=n, spec=TOPK_SPEC, rounds_before_save=first,
                rounds_after_restore=then, leaves=len(equal),
                resid_name=".dpps/.resid", bit_equal_state=True,
                bit_equal_trajectory=True, launches=launches)


def wire_training(torch, T, ops, f32_step_ms: float) -> dict:
    """Phase 15's session (llama3.2-1b full width, N = 4) under int8, 3
    steps with a ``LedgerHook`` and a ``NetworkStatsHook``: ms a step and
    a DPPS round beside phase 15's, peak memory, exact launches, the
    ledger's codec and bytes, the compression ratio."""
    from repro_torch.api import LedgerHook
    from repro_torch.net import NetworkStatsHook
    from repro_torch.wire import Int8StochasticCodec

    session, batches, gamma_n = lm_session(torch, T,
                                           wire=Int8StochasticCodec())
    steps = LOOP_STEPS
    hooks = [LedgerHook(), NetworkStatsHook()]
    events = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep, step_ms = timed_train(torch, session, batches, steps, events,
                               hooks=hooks)
    launches = ops.launch_counts()
    want = tree_launches(1, 0, steps, 5)
    require(launches == want, f"launches {launches}, expected {want}")
    loss = [float(x) for x in rep.trajectory["loss_mean"]]
    require(all(math.isfinite(x) for x in loss), f"losses {loss}")
    a_mean = rep.state.dpps.push.a.double().mean().item()
    require(abs(a_mean - 1.0) < 1e-5, f"mean(a) = {a_mean}")
    entry = hooks[0].ledger.entries[0]
    require(entry["wire_codec"] == "int8"
            and entry["wire_bytes_per_edge"] == TRAIN_LM["d_s"] + 4,
            f"ledger {entry}")
    network = rep.network.summary()
    dpps_ms = [a.elapsed_time(b) for a, b, _ in events["dpps_step"]]
    line = dict(arch=TRAIN_LM["arch"], nodes=TRAIN_LM["n"],
                d_s=TRAIN_LM["d_s"], spec="int8", steps=steps,
                gamma_n=gamma_n, step_ms=step_ms,
                ms_per_step=sum(step_ms[1:]) / (steps - 1),
                f32_ms_per_step_phase15=f32_step_ms, dpps_round_ms=dpps_ms,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                losses=loss, a_mean=a_mean, launches=launches,
                ledger_wire=dict(wire_codec=entry["wire_codec"],
                                 wire_bytes_per_edge=entry[
                                     "wire_bytes_per_edge"]),
                network=network)
    del rep, session, batches
    torch.cuda.empty_cache()
    return line


def wire_phase(torch, api, mlp, data, ops, T, dev, tmp: str, *,
               f32_ms: float, f32_step_ms: float) -> tuple[dict, list]:
    """Phase 26: (a) int8 and bf16 consensus at the dense full width; (b)
    card against CPU under each codec; (c) llama3.2-1b training under
    int8; (d) top-k on the MLP, dense (N = 10) and sparse (ER(128)); (e)
    int8 under delays on ER(128); (f) a top-k resume."""
    counts, parts = [], {}

    def part(name: str, line: dict) -> None:
        # each part on its own line as it ends; the phase's line sums up
        emit(dict(phase="wire", part=name, **line))
        parts[name] = line
        if "launches" in line:
            counts.append(line["launches"])

    for spec in WIRE_FULL_SPECS:
        part(f"consensus_{spec}",
             wire_consensus(torch, api, T, ops, dev, spec, f32_ms))
    part("agreement", wire_agreement(torch, api, T, dev))
    part("training_agreement",
         wire_training_agreement(torch, api, mlp, data))
    part("training_int8", wire_training(torch, T, ops, f32_step_ms))
    for schedule, topo in (("dense", T.DOutGraph(PAPER["n"], 2)),
                           ("sparse", sparse_graph(SPARSE_TRAIN_N))):
        part(f"topk_{schedule}", topk_training(
            torch, api, mlp, data, ops, dev, topo=topo, schedule=schedule))
    part("int8_async", int8_async(torch, api, mlp, data, ops, dev))
    part("topk_resume", topk_resume(torch, api, mlp, data, ops, dev, tmp))
    summary = {name: {k: v for k, v in line.items()
                      if k in ("ms_per_round", "ms_per_step", "draw_ms",
                               "encode_ms", "peak_mem_gb",
                               "peak_reckoned_gb", "compression_ratio",
                               "launches", "results")}
               for name, line in parts.items()}
    return dict(phase="wire", summary=summary), counts


# -- phase 27: the privacy audit lab ------------------------------------------

AUDIT_MECHANISMS = ("laplace", "gaussian", "graph_homomorphic",
                    "broken_laplace")
AUDIT_WIRE = ("int8", TOPK_SPEC, "broken-compress-first")
AUDIT_WIRE_TRIALS = 800
# the main battery's trials: ``AuditConfig()``'s default 1,500 cut to the
# wire battery's 800 for the script's time limit with phase 34 (the fig5
# claims hold at 400 in tests/test_torch_audit.py)
AUDIT_TRIALS = 800
MEMBERSHIP = dict(steps=60, examples=200)


def audit_cells(results) -> list:
    return [dict(mechanism=r.mechanism, threat=r.threat,
                 eps_emp=r.empirical.epsilon_lower,
                 eps_claim=r.theoretical_epsilon, flagged=r.flagged,
                 trials=r.empirical.trials, tpr=r.empirical.tpr,
                 fpr=r.empirical.fpr) for r in results]


def membership(torch, api, mlp, data, dev) -> dict:
    """Membership inference on PartPSP-1 shared parameters (the paper MLP,
    2-out, N = 10), as ``benchmarks/fig5_audit.py::run_membership`` runs
    it: train 60 steps, then threshold the per-example losses under node
    0's consensus view of its own training examples (members) against
    fresh draws of the task (non-members). gamma_n 1e-5: the reference's
    1e-4 sits outside the stability region at the calibrated constants."""
    from repro_torch.audit import example_scores, membership_inference
    from repro_torch.core.topology import DOutGraph

    n, steps = PAPER["n"], MEMBERSHIP["steps"]
    batches = training_batches(mlp, data, torch, n, steps)
    session, batch_at = training_setup(api, mlp, torch, None,
                                       topo=DOutGraph(n, 2), schedule="dense",
                                       batches=batches)
    rep = session.train(steps, batch_at)
    params = session.consensus_view(rep.state, 0)
    m = MEMBERSHIP["examples"]
    x_in = torch.cat([b[0][0] for b in batches])[:m].to(dev)
    y_in = torch.cat([b[1][0] for b in batches])[:m].to(dev)
    task = data.SyntheticClassification(d_in=mlp.D_IN, seed=SEED,
                                        device="cpu")
    x_out, y_out = task.sample(torch.Generator().manual_seed(SEED + 123), m)
    s_in = example_scores(mlp.mlp_loss, params, x_in, y_in)
    s_out = example_scores(mlp.mlp_loss, params, x_out.to(dev),
                           y_out.to(dev))
    est = membership_inference(s_in, s_out)
    return dict(steps=steps, examples=m, eps_emp=est.epsilon_lower,
                trials=est.trials, tpr=est.tpr, fpr=est.fpr,
                loss_members=float(s_in.mean()),
                loss_nonmembers=float(s_out.mean()))


def audit_phase(torch, api, mlp, data, ops, dev) -> tuple[dict, list]:
    """Phase 27: the attack battery on the card at ``AuditConfig()``'s
    setting (N = 4, dim 16) with AUDIT_TRIALS trials: four mechanisms
    under the three threats (the
    default Laplace through dpps_perturb.cu, the mechanisms' draws through
    laplace_noise.cu), the fig5 claims held; the wire battery at 800
    trials, its claims held; ``LaplaceMechanism()`` bit for bit the default
    on 50 trials; the reconstruction table; membership inference."""
    from repro_torch.audit import (GLOBAL_OBSERVER, LOCAL_EAVESDROPPER,
                                   THREAT_MODELS, AuditConfig,
                                   distinguishing_attack, get_mechanism,
                                   reconstruction_attack)
    from repro_torch.audit.attacks import tapped_trials
    from repro_torch.wire import parse_wire_spec

    counts = []
    audit = AuditConfig(trials=AUDIT_TRIALS)
    same = AuditConfig(trials=50)
    # a comparison, not the path: its launches are read here and left out
    # of the kernels line
    ops.reset_launch_counts()
    a = tapped_trials(same, None, 0)
    b = tapped_trials(same, get_mechanism("laplace"), 0)
    compared = ops.launch_counts()
    bit_equal = {k: bool((a[k] == b[k]).all()) for k in a}
    require(all(bit_equal.values()), f"Laplace mechanism != default: "
                                     f"{bit_equal}")
    require(compared["laplace_from_bits"] == same.trials
            and compared["noise_l1_rows"] == same.trials * same.rounds,
            f"mechanism draws launched {compared}")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    grid = []
    for name in AUDIT_MECHANISMS:
        mech = None if name == "laplace" else get_mechanism(name)
        for threat in THREAT_MODELS:
            grid.append(distinguishing_attack(threat, mechanism=mech,
                                              audit=audit))
    counts.append(ops.launch_counts())
    grid_s = time.perf_counter() - t0
    require(all(counts[-1][k] > 0 for k in DENSE_PATH + (
        "laplace_from_bits", "noise_l1_rows")),
            f"the battery missed a kernel: {counts[-1]}")
    by = {(r.mechanism, r.threat): r for r in grid}
    for t in THREAT_MODELS:
        require(not by[("laplace", t.name)].flagged,
                f"Laplace flagged under {t.name}: {by[('laplace', t.name)]}")
    require(any(by[("broken_laplace", t.name)].flagged
                for t in THREAT_MODELS), "broken Laplace not flagged")
    require(not by[("graph_homomorphic", LOCAL_EAVESDROPPER.name)].flagged,
            "graph-homomorphic flagged by the eavesdropper")
    require(by[("graph_homomorphic", GLOBAL_OBSERVER.name)].flagged,
            "graph-homomorphic not flagged by the global observer")
    t0 = time.perf_counter()
    wire, wire_counts = [], {}
    for spec in AUDIT_WIRE:
        cfg = AuditConfig(trials=AUDIT_WIRE_TRIALS,
                          wire=parse_wire_spec(spec))
        ops.reset_launch_counts()
        for threat in THREAT_MODELS:
            r = distinguishing_attack(threat, audit=cfg)
            wire.append(dict(audit_cells([r])[0], wire=spec))
        wire_counts[spec] = ops.launch_counts()
        counts.append(wire_counts[spec])
        # every cell on the kernels: the honest codecs encode the fused
        # perturbation's output; the compress-first codec draws its
        # down-scaled noise through laplace_noise.cu
        drawn = (("laplace_from_bits", "noise_l1_rows")
                 if cfg.wire.compress_before_noise else ("dpps_perturb_rows",))
        require(all(wire_counts[spec][k] > 0
                    for k in ("l1_norm_rows", "pushsum_mix") + drawn),
                f"{spec} battery missed a kernel: {wire_counts[spec]}")
    wire_s = time.perf_counter() - t0
    for cell in wire:
        if cell["wire"] != "broken-compress-first":
            require(not cell["flagged"], f"honest codec flagged: {cell}")
    require(any(c["flagged"] for c in wire
                if c["wire"] == "broken-compress-first"),
            "compress-first codec not flagged")
    ops.reset_launch_counts()
    recon = {name: reconstruction_attack(
        mechanism=None if name == "laplace" else get_mechanism(name),
        audit=AuditConfig(trials=AUDIT_WIRE_TRIALS))
        for name in ("laplace", "graph_homomorphic")}
    counts.append(ops.launch_counts())
    ops.reset_launch_counts()
    mia = membership(torch, api, mlp, data, dev)
    counts.append(ops.launch_counts())
    return dict(phase="audit", n=audit.n_nodes, dim=audit.dim,
                trials=audit.trials, laplace_mechanism_bit_equal=bit_equal,
                cells=audit_cells(grid), battery_s=grid_s,
                battery_launches=counts[0], wire_trials=AUDIT_WIRE_TRIALS,
                wire_cells=wire, wire_battery_s=wire_s,
                wire_battery_launches=wire_counts,
                laplace_mechanism_compare_launches=compared,
                reconstruction=recon,
                membership=mia), counts


# -- phase 28: the observability layer ---------------------------------------

# a device kernel's name (the profiler's demangled one) -> the phase its
# launch falls in, the reference's layout (repro/core/dpps.py): the eps norm
# in the perturbation, the fused perturbation in the noise, the mix in the
# gossip (pushsum_mix's own range nests there); round 0's norm of s^(0) is
# the sensitivity's init
KERNEL_PHASES = {"l1_norm_kernel": "dpps_perturb",
                 "perturb_kernel": "dpps_noise",
                 "mix_kernel": "dpps_gossip", "mix_tile_kernel": "dpps_gossip",
                 "spmm_rows_kernel": "dpps_gossip",
                 "spmm_tiles_kernel": "dpps_gossip"}
OBS_ROUNDS = 3
OBS_ASYNC = dict(rounds=20, chunk=5)
OBS_WATCH_ROUNDS = 10
OBS_RECORD = dict(n=5, d_s=1 << 24, rounds=10, chunk=2)
OBS_CLI = ["--arch", "llama3.2-1b", "--reduced", "--nodes", "4",
           "--steps", "3", "--topology", "er", "--er-p", "0.5",
           "--drop-rate", "0.1", "--wire", "int8", "--use-kernels",
           "--gamma-n", "1e-7", "--log-every", "1"]
# PERF.md §5's figures from before the phase annotations (H100 80GB HBM3
# at 700 W): the paper MLP's step dense and sparse, the ER(4096) round, ms
PRE_OBS_MS = dict(mlp_dense_step=6.31, mlp_sparse_step=3.17,
                  er4096_round=0.445)


def kernel_of(name: str) -> str | None:
    for k in KERNEL_PHASES:
        if re.search(rf"\b{k}\b", name):
            return k
    return None


def kernel_phases(torch, run) -> dict:
    """``run()`` under ``torch.profiler`` (CPU and CUDA): each kernel of
    ``KERNEL_PHASES`` by the phase its launches fall in, as
    ``repro_torch.obs.trace.attribute`` places them -> {kernel: {phase:
    launches}}; with none found, what the profiler did record."""
    from repro_torch.obs.trace import attribute

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    events = prof.events()
    found: dict = {}
    for name, where, _ in attribute(events, device="cuda")[0]:
        k = kernel_of(name)
        if k is not None:
            found.setdefault(k, {})
            found[k][where] = found[k].get(where, 0) + 1
    if not found:  # what the profiler did record, for the failure below
        device = [e.name for e in events
                  if e.device_type != torch.autograd.DeviceType.CPU]
        free, total = torch.cuda.mem_get_info()
        found["recorded"] = dict(
            events=len(events), device_events=len(device),
            device_names=sorted(set(n[:60] for n in device))[:20],
            free_gb=free / 1e9, total_gb=total / 1e9,
            reserved_gb=torch.cuda.memory_reserved() / 1e9)
    return found


def obs_session(torch, api, T, dev, *, topo, shape: dict, schedule: str,
                **build_kw):
    """Phase 3's session and values at ``shape``: constants calibrated,
    gamma_n half the Remark-1 limit."""
    n, d_s = shape["n"], shape["d_s"]
    c_prime, lam = T.calibrate_constants(topo)
    gamma_n = 0.5 * (1.0 / lam - 1.0) / (2.0 * c_prime * d_s)
    session = api.Session.build(topo, privacy=api.PrivacySpec(
        b=1.0, gamma_n=gamma_n, c_prime=c_prime, lam=lam), schedule=schedule,
        seed=SEED, **build_kw)
    require(session.plan.use_kernels and session.device.type == "cuda",
            "the session did not pick the card and its kernels")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return session, {"shared": torch.randn((n, d_s), generator=gen,
                                           device=dev)}


def profile_consensus(torch, api, T, ops, dev, *, topo, shape: dict,
                      schedule: str, mix: str, breakdown: dict) -> tuple:
    """28a: ``Session.profile(OBS_ROUNDS, state=...)`` at ``shape``: a
    non-empty breakdown with no note, its phases summing to the device
    total, the passed state unchanged (bit for bit against a copy); each
    phase's ms a round beside phase 3's kernel times (``breakdown``); then
    the same rounds by ``run`` under the profiler, every norm,
    perturbation and mix launch in its phase."""
    session, values = obs_session(torch, api, T, dev, topo=topo, shape=shape,
                                  schedule=schedule)
    state = session.consensus_state(values)
    before = state.push.s["shared"].clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = session.profile(OBS_ROUNDS, state=state)
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(rep.note is None and rep.phases, f"profile: {rep.note}")
    require(rep.backend == "torch-cuda", rep.backend)
    require(abs(sum(rep.phases.values()) - rep.device_total_s)
            <= 1e-9 + 1e-9 * rep.device_total_s, "phases do not sum")
    require(torch.equal(state.push.s["shared"], before) and state.t == 0,
            "profile changed the passed state")
    del before
    from repro_torch.core.dpps import is_sync_round

    sync = session.cfg.sync_interval
    mixes = sum(not is_sync_round(t, sync) for t in range(OBS_ROUNDS))
    ops.reset_launch_counts()
    found = kernel_phases(torch, lambda: session.run(OBS_ROUNDS,
                                                     state=state))
    checked = ops.launch_counts()
    want = {"l1_norm_kernel": {"dpps_perturb": OBS_ROUNDS,
                               "dpps_sensitivity": 1},
            "perturb_kernel": {"dpps_noise": OBS_ROUNDS}}
    got_mix = {}
    for k, by in found.items():
        if k not in want:
            for where, c in by.items():
                got_mix[where] = got_mix.get(where, 0) + c
    require({k: found.get(k) for k in want} == want,
            f"norm/perturbation launches by phase {found}")
    require(got_mix == {"dpps_gossip": mixes} and checked[mix] == mixes,
            f"mix launches by phase {got_mix}, counted {checked[mix]}")
    per_round = {k: v * 1e3 / OBS_ROUNDS for k, v in sorted(
        rep.phases.items(), key=lambda kv: -kv[1])}
    del state, values, session
    torch.cuda.empty_cache()
    return dict(shape=shape, schedule=schedule, topology=type(topo).__name__,
                rounds=OBS_ROUNDS, sync_interval=sync,
                summary=rep.summary(), phases_ms_per_round=per_round,
                device_total_ms_per_round=rep.device_total_s * 1e3
                / OBS_ROUNDS,
                round_breakdown_ms=breakdown, kernels_by_phase=found,
                peak_mem_gb=peak_gb), launches


def profile_training(torch, T, ops) -> tuple:
    """28b: ``Session.profile(1, batch_at=...)`` of phase 15's session
    (llama3.2-1b at full width, N = 4): the gradient phases' share of the
    device time against the DPPS round's phases."""
    session, batches, _ = lm_session(torch, T)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rep = session.profile(1, batch_at=lambda t: batches[t])
    launches = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    require(rep.phases, f"profile: {rep.note}")
    require(abs(sum(rep.phases.values()) - rep.device_total_s)
            <= 1e-9 + 1e-9 * rep.device_total_s, "phases do not sum")
    grads = ("partpsp_local_grads", "partpsp_shared_grads", "partpsp_clip")
    dpps = [k for k in rep.phases if k.startswith("dpps_")]
    total = rep.device_total_s
    share = {k: v / total for k, v in rep.phases.items()}
    require(all(share.get(k, 0.0) > 0.0 for k in grads[:2]),
            f"no gradient phase: {rep.phases}")
    del session, batches
    torch.cuda.empty_cache()
    return dict(arch=TRAIN_LM["arch"], n=TRAIN_LM["n"], d_s=TRAIN_LM["d_s"],
                summary=rep.summary(), shares=share,
                gradient_share=sum(share.get(k, 0.0) for k in grads),
                dpps_share=sum(share[k] for k in dpps),
                dpps_ms=sum(rep.phases[k] for k in dpps) * 1e3,
                peak_mem_gb=peak_gb), launches


def watched_async(torch, api, T, ops, dev, tmp: str) -> tuple:
    """28c: phase 25's async consensus at llama's shared width (N = 4, B =
    2, drops 0.1), ``OBS_ASYNC`` rounds under ``WatchdogHook(strict=True)``,
    ``TimelineHook``, ``MetricsHook``, a ``JsonlExporter`` on their bus and
    ``write_prometheus``: no alert, a valid Chrome trace whose
    ``send->deliver`` counts sum to ``async_delay_hist``'s."""
    from repro_torch.net import DelayModel, FaultModel
    from repro_torch.obs import (JsonlExporter, MetricsBus, TimelineHook,
                                 WatchdogHook, validate_chrome_trace,
                                 write_prometheus)

    rounds = OBS_ASYNC["rounds"]
    session, values = obs_session(
        torch, api, T, dev, topo=T.DOutGraph(TRAIN_FULL["n"], 2),
        shape=TRAIN_FULL, schedule="dense", sync_interval=0,
        chunk=OBS_ASYNC["chunk"], delays=DelayModel(**DELAYS),
        faults=FaultModel(drop_rate=0.1))
    paths = {k: str(Path(tmp) / name) for k, name in (
        ("trace", "timeline.json"), ("events", "events.jsonl"),
        ("prom", "metrics.prom"))}
    bus = MetricsBus()
    exporter = JsonlExporter(paths["events"]).attach(bus)
    watchdog = WatchdogHook(strict=True, bus=bus)
    timeline = TimelineHook(paths["trace"], bus=bus)
    metrics = api.MetricsHook(fields={"sens": "sensitivity_estimate",
                                      "mass": "async_mass_mean"},
                              log_every=10 ** 9, print_fn=lambda s: None,
                              bus=bus)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = session.run(rounds, values=values,
                      hooks=[watchdog, timeline, metrics])
    torch.cuda.synchronize()
    run_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    exporter.close()
    write_prometheus(bus, paths["prom"])
    require(not rep.aborted and rep.rounds == rounds,
            f"watched run aborted: {rep.abort_reason}")
    require(watchdog.alerts == [], f"alerts {watchdog.alerts}")
    obj = json.loads(Path(paths["trace"]).read_text())
    validate_chrome_trace(obj)
    evs = obj["traceEvents"]
    sent = sum(e["args"]["count"] for e in evs if e["ph"] == "b")
    hist = int(rep.trajectory["async_delay_hist"].sum())
    require(sent == hist, f"send->deliver counts {sent}, histogram {hist}")
    require(len(metrics.history) == rounds, "metrics history")
    sizes = {k: Path(p).stat().st_size for k, p in paths.items()}
    kinds = {}
    for e in evs:
        kinds[e["ph"]] = kinds.get(e["ph"], 0) + 1
    del rep, values, session
    torch.cuda.empty_cache()
    return dict(n=TRAIN_FULL["n"], d_s=TRAIN_FULL["d_s"], rounds=rounds,
                chunk=OBS_ASYNC["chunk"],
                delays=dict(DELAYS, rates=list(DELAYS["rates"])),
                faults=dict(drop_rate=0.1), run_ms=run_ms,
                ms_per_round=run_ms / rounds, alerts=0,
                trace_events=len(evs), trace_events_by_kind=kinds,
                send_deliver_messages=sent, exporter_lines=exporter.written,
                bytes=sizes), launches


def watchdog_phase(torch, api, T, ops, dev) -> tuple:
    """28d: a NaN in one node's values (N = 5, d_s = 4096, chunk 2) makes
    the strict watchdog abort at round 0 with ``nonfinite_wire``; then the
    watchdog's cost at the dense full width: ``run(OBS_WATCH_ROUNDS)``
    without and with it, in turns (plain, watched, watched, plain)."""
    from repro_torch.obs import MetricsBus, WatchdogHook

    session = api.Session.build(T.DOutGraph(5, 2), privacy=api.PrivacySpec(
        b=5.0, gamma_n=1e-4), schedule="dense", chunk=2, seed=SEED)
    x = torch.randn((5, 4096), device=dev)
    x[2, 7] = float("nan")
    strict = WatchdogHook(strict=True, warn=lambda m: None, bus=MetricsBus())
    ops.reset_launch_counts()
    rep = session.run(6, values={"x": x}, hooks=[strict])
    counts = [ops.launch_counts()]
    first = strict.alerts[0] if strict.alerts else None
    require(rep.aborted and rep.rounds == 2 and first is not None
            and (first.check, first.round) == ("nonfinite_wire", 0),
            f"NaN run: aborted={rep.aborted} rounds={rep.rounds} {first}")
    nan = dict(aborted=rep.aborted, rounds=rep.rounds,
               abort_reason=rep.abort_reason,
               first_alert=dict(check=first.check, round=first.round,
                                severity=first.severity, value=first.value))

    session, values = obs_session(torch, api, T, dev,
                                  topo=T.DOutGraph(FULL["n"], 2), shape=FULL,
                                  schedule="dense")
    session.run(1, values=values)  # warm
    ms = {"plain": [], "watched": []}
    for kind in ("plain", "watched", "watched", "plain"):
        hook = WatchdogHook(warn=lambda m: None, bus=MetricsBus())
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rep = session.run(OBS_WATCH_ROUNDS, values=values,
                          hooks=[hook] if kind == "watched" else [])
        torch.cuda.synchronize()
        ms[kind].append((time.perf_counter() - t0) * 1e3 / OBS_WATCH_ROUNDS)
        counts.append(ops.launch_counts())
        if kind == "watched":
            require(hook.alerts == [], f"alerts {hook.alerts}")
        del rep
    del values, session
    torch.cuda.empty_cache()
    plain, watched = (sum(v) / len(v) for v in (ms["plain"], ms["watched"]))
    return dict(nan_abort=nan, shape=FULL, rounds=OBS_WATCH_ROUNDS,
                ms_per_round=ms, watchdog_ms_per_round=watched - plain), counts


def record_phase(torch, api, T, ops, dev, tmp: str) -> tuple:
    """28e: two ``Session.record`` s of a consensus run into a temporary
    history, ``registry.check`` passes; a synthetic 2x ``us_per_round``
    record is named as a regression."""
    import dataclasses

    from repro_torch.obs import registry

    session, values = obs_session(
        torch, api, T, dev, topo=T.DOutGraph(OBS_RECORD["n"], 2),
        shape=OBS_RECORD, schedule="dense", chunk=OBS_RECORD["chunk"])
    history = str(Path(tmp) / "history.jsonl")
    session.run(OBS_RECORD["rounds"], values=values)  # warm
    ops.reset_launch_counts()
    recs = [session.record(session.run(OBS_RECORD["rounds"], values=values),
                           name="chip_smoke", history=history)
            for _ in range(2)]
    launches = ops.launch_counts()
    regressions, lines = registry.check(history)
    require(regressions == [], f"registry check: {lines}")
    base = [r.metrics["us_per_round"] for r in recs]
    slow = dataclasses.replace(recs[-1], metrics=dict(
        recs[-1].metrics, us_per_round=2.0 * sum(base) / len(base)))
    registry.append_record(slow, history)
    regressions, slow_lines = registry.check(history)
    require(regressions == ["us_per_round"], f"slowdown: {slow_lines}")
    del values, session
    return dict(shape=OBS_RECORD, backend=recs[0].backend,
                scale=recs[0].scale, metrics=[r.metrics for r in recs],
                check=lines, slowdown_check=slow_lines), launches


def cli_phase(ops) -> tuple:
    """28f: ``launch/train.py`` through the shared CLI on the card: 3 steps
    of the reduced llama3.2-1b on ER(4, p = 0.5) under drops, the int8
    wire and the kernels."""
    import contextlib
    import io

    from repro_torch.launch import train as train_cli

    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        train_cli.main(OBS_CLI)
    seconds = time.perf_counter() - t0
    launches = ops.launch_counts()
    text = out.getvalue()
    require("wire=int8 " in text and "kernels=True" in text
            and "schedule=dynamic" in text and "privacy:" in text,
            f"launcher output: {text}")
    require(launches["l1_norm_rows"] > 0 and launches["dpps_perturb_rows"]
            and launches["pushsum_mix"] > 0, f"launches {launches}")
    return dict(argv=OBS_CLI, seconds=seconds, stdout=text.splitlines(),
                launches=launches), launches


def obs_subprocess(torch, **kw) -> tuple[dict, list]:
    """Phase 28 in a fresh process (``chip_smoke.py --obs-phase JSON``),
    its line and launch counts read back from its last stdout line: the
    profiler drops device events in a process that has run for minutes
    (PERF.md §7), so the profiles run where it has just started."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--obs-phase",
         json.dumps(kw)], capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    require(proc.returncode == 0 and lines,
            f"phase 28 exited {proc.returncode}: {proc.stderr[-4000:]}")
    result = json.loads(lines[-1])
    return result["out"], result["counts"]


def obs_phase(torch, api, T, ops, dev, *, dense: dict, sparse: dict,
              mlp_ms: dict, er_ms: float) -> tuple[dict, list]:
    """Phase 28: the observability layer and the shared CLI on the card
    (28a-f, above); then the cost of the phase annotations: the paper MLP's
    step and the ER(4096) round measured in this run (phases 4, 6 and 13,
    annotated) beside PERF.md §5's figures from before them."""
    counts = []
    out = {"phase": "obs"}
    out["profile_dense"], c = profile_consensus(
        torch, api, T, ops, dev, topo=T.DOutGraph(FULL["n"], 2), shape=FULL,
        schedule="dense", mix="pushsum_mix", breakdown=dense)
    counts.append(c)
    out["profile_sparse"], c = profile_consensus(
        torch, api, T, ops, dev, topo=sparse_graph(SPARSE_FULL["n"]),
        shape=SPARSE_FULL, schedule="sparse", mix="spmm", breakdown=sparse)
    counts.append(c)
    out["profile_training"], c = profile_training(torch, T, ops)
    counts.append(c)
    with tempfile.TemporaryDirectory() as tmp:
        out["watched_async"], c = watched_async(torch, api, T, ops, dev, tmp)
        counts.append(c)
        out["watchdog"], cs = watchdog_phase(torch, api, T, ops, dev)
        counts += cs
        out["record"], c = record_phase(torch, api, T, ops, dev, tmp)
        counts.append(c)
    out["cli"], c = cli_phase(ops)
    counts.append(c)
    out["annotation_cost_ms"] = dict(
        this_run=dict(mlp_dense_step=mlp_ms["dense"],
                      mlp_sparse_step=mlp_ms["sparse"], er4096_round=er_ms),
        before=PRE_OBS_MS)
    torch.cuda.empty_cache()
    return out, counts


# -- phase 29: the launch tooling ----------------------------------------------

# 29a: the dry run at the reference's single-pod node count, one process an
# architecture (all at once: each traces on meta, on the host alone)
DRYRUN_NODES = 16
# 29b-c: a predicted peak is held within this share of the card's. The
# largest gap measured on an H100 80GB HBM3 at 700 W was 0.14 % (29b:
# 47.399 GB against 47.331 predicted) and the smallest 4e-7; one node's
# stacked gradient is 10.4 % of 29b's peak, so a count that dropped it
# fails here
PEAK_TOLERANCE = 0.01
# 29b: the TRAIN_LM step (N = 4, 2 x 1,024 tokens a node) as a ShapeSpec
TRAIN_LM_SHAPE = dict(name="train_lm", seq_len=TRAIN_LM["seq_len"],
                      global_batch=TRAIN_LM["n"] * TRAIN_LM["per_node_batch"],
                      kind="train")
LAUNCH_TIMED_STEPS = 2
# 29c runs the fitting decode row only: the one prefill row that fits,
# xlstm-125m's prefill_32k (B = 32, S = 32,768), took 47.8 s even at one
# mLSTM and one sLSTM layer of its 12 on an H100 80GB HBM3 at 700 W (its
# time loops are 32,768 steps a layer), and left for phase 34's time


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def dryrun_start(tmp: str) -> dict:
    """29a: ``python -m repro_torch.launch.dryrun --arch A --nodes 16
    --out tmp/A.json`` for every architecture, all started at once, on
    meta with the card hidden, niced -> {arch: Popen}."""
    from repro_torch.configs import ARCH_NAMES

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    return {arch: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--nodes", str(DRYRUN_NODES), "--out", f"{tmp}/{arch}.json"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        preexec_fn=niced)
        for arch in ARCH_NAMES}


def dryrun_finish(procs: dict, tmp: str, t0: float, card: str) -> tuple:
    """29a's rows: no error row, the reference's skips (long_500k for the
    full-attention architectures), every ok row's FLOPs > 0. ``wall_s``
    runs from the processes' start (``t0``, before phase 24) to here,
    ``wait_s`` is what phase 29 waited for them."""
    from repro_torch.configs import INPUT_SHAPES, get_config

    rows = []
    t_wait = time.perf_counter()
    for arch, proc in procs.items():
        out, _ = proc.communicate(timeout=600)
        require(proc.returncode == 0,
                f"dry run of {arch} exited {proc.returncode}: {out[-3000:]}")
        rows += json.loads(Path(f"{tmp}/{arch}.json").read_text())
    wall_s, wait_s = time.perf_counter() - t0, time.perf_counter() - t_wait
    want = {(a, sh) for a in procs for sh in INPUT_SHAPES}
    require({(r["arch"], r["shape"]) for r in rows} == want, "dry-run rows")
    require(not [r for r in rows if r["status"] == "error"], "dry-run errors")
    skipped = {(r["arch"], r["shape"]) for r in rows
               if r["status"] == "skipped"}
    require(skipped == {(a, "long_500k") for a in procs
                        if not get_config(a).runs_shape("long_500k")},
            f"dry-run skips {sorted(skipped)}")
    ok = [r for r in rows if r["status"] == "ok"]
    require(all(r["flops_per_chip"] > 0 for r in ok), "a row counts no FLOPs")
    return dict(
        phase="launch", part="dryrun", card=card, nodes=DRYRUN_NODES,
        processes=len(procs), wall_s=wall_s, wait_s=wait_s, ok=len(ok),
        skipped=len(skipped), errors=0,
        max_trace_s=max(r["trace_s"] for r in ok),
        rows=[dict(arch=r["arch"], shape=r["shape"], status=r["status"],
                   **({k: r[k] for k in (
                       "flops_per_chip", "aten_flops", "kernel_flops",
                       "bytes_per_chip", "peak_bytes", "fits", "bottleneck",
                       "model_flops_per_chip", "useful_flops_ratio",
                       "launches", "trace_s")} if r["status"] == "ok"
                      else {"reason": r["reason"]})) for r in rows]), rows


def peak_within(pred: float, measured: float, what: str) -> float:
    rel = abs(pred - measured) / measured
    require(rel <= PEAK_TOLERANCE,
            f"{what}: predicted peak {pred / 1e9:.3f} GB, measured "
            f"{measured / 1e9:.3f} GB ({100 * rel:.1f} % apart)")
    return rel


def launch_train(torch, ops, dev, card: str) -> tuple:
    """29b: the TRAIN_LM step (llama3.2-1b, N = 4, 2 x 1,024 tokens a node)
    as a ``TrainPlan``: predicted by ``cost()`` on meta, then run on the
    card. The aten FLOPs ``FlopCounterMode`` counts on the card equal the
    prediction's, the card's launches its meta launches, the measured peak
    (over what was allocated before the state) its peak within
    ``PEAK_TOLERANCE``; then the step timed without the counter."""
    import dataclasses

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.op_analysis import HW
    from repro_torch.launch.steps import build_train_plan

    arch = get_config(TRAIN_LM["arch"])
    plan = build_train_plan(arch, TRAIN_LM["n"],
                            shape=ShapeSpec(**TRAIN_LM_SHAPE))
    # gamma_n at half the Remark-1 stability limit of the plan's (C',
    # lambda) at this d_s: the reference's default 0.01 diverges in a few
    # rounds at full width (the counts do not depend on it)
    dpps = plan.cfg.dpps
    limit = (1.0 / dpps.lam - 1.0) * dpps.b / (
        2.0 * dpps.c_prime * plan.partition.d_shared())
    plan.cfg = dataclasses.replace(plan.cfg, dpps=dataclasses.replace(
        dpps, gamma_n=0.5 * limit))
    t0 = time.perf_counter()
    pred = plan.cost()
    predict_s = time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state = plan.init_state(dev, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = {"tokens": torch.randint(
        0, arch.model.vocab_size, tuple(plan.batch_specs["tokens"].shape),
        generator=gen, device=dev, dtype=torch.int32)}
    torch.cuda.synchronize()
    state_gb = (torch.cuda.memory_allocated() - base) / 1e9
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with FlopCounterMode(display=False) as counter:
        state, metrics = plan.step_fn(state, batch, SEED)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = ops.launch_counts()
    card_flops = float(counter.get_total_flops())
    require(card_flops == pred.aten_flops,
            f"card aten FLOPs {card_flops} != predicted {pred.aten_flops}")
    require(launches == {k: pred.launches.get(k, 0) for k in launches},
            f"card launches {launches} != predicted {pred.launches}")
    rel = peak_within(pred.peak_memory_bytes, peak, "TrainPlan step")
    loss = float(metrics["loss_mean"])
    require(math.isfinite(loss), f"loss {loss}")
    ms = []
    for t in range(LAUNCH_TIMED_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = plan.step_fn(state, batch, SEED + 1 + t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
    require(all(bool(torch.isfinite(x).all()) for x in state.local),
            "trained state not finite")
    step_ms = min(ms)
    tflops = card_flops / (step_ms / 1e3) / 1e12
    out = dict(
        phase="launch", part="train", card=card, arch=TRAIN_LM["arch"],
        nodes=TRAIN_LM["n"], shape=TRAIN_LM_SHAPE,
        d_s=plan.partition.d_shared(), gamma_n=plan.cfg.dpps.gamma_n,
        predict_s=predict_s, state_gb=state_gb,
        predicted=dict(aten_flops=pred.aten_flops,
                       kernel_flops=pred.kernel_flops, flops=pred.flops,
                       bytes=pred.bytes_accessed,
                       peak_gb=pred.peak_memory_bytes / 1e9,
                       launches=pred.launches, model_flops=pred.model_flops,
                       f32_floor_ms=pred.t_compute * 1e3,
                       memory_floor_ms=pred.t_memory * 1e3),
        card_aten_flops=card_flops, card_launches=launches,
        peak_gb=peak / 1e9, peak_rel_diff=rel, loss=loss, step_ms=ms,
        achieved_tflops=tflops, share_of_f32_peak=tflops * 1e12
        / HW.peak_flops("float32"),
        model_tflops=pred.model_flops / (step_ms / 1e3) / 1e12)
    del state, batch, metrics
    torch.cuda.empty_cache()
    return out, launches


def launch_serve(torch, ops, dev, rows: list, card: str) -> tuple:
    """29c: of 29a's decode rows marked ``fits``, the one with the largest
    predicted peak: one ``ServePlan.step_fn`` on the card, its measured
    peak against the row's within ``PEAK_TOLERANCE`` and its launches
    against the row's."""
    from repro_torch.configs import INPUT_SHAPES, get_config
    from repro_torch.launch.steps import build_serve_plan

    out, counts = dict(phase="launch", part="serve", card=card), []
    for kind in ("decode",):
        fit = [r for r in rows if r["status"] == "ok" and r["fits"]
               and INPUT_SHAPES[r["shape"]].kind == kind]
        require(fit, f"no {kind} row fits the card")
        row = max(fit, key=lambda r: r["peak_bytes"])
        plan = build_serve_plan(get_config(row["arch"]),
                                shape_name=row["shape"])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        args = plan.init_args(dev, seed=SEED)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = plan.step_fn(*args)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        launches = ops.launch_counts()
        counts.append(launches)
        require(bool(torch.isfinite(logits).all()), f"{kind} logits")
        require(launches == {k: row["launches"].get(k, 0) for k in launches},
                f"{kind} launches {launches} != predicted {row['launches']}")
        rel = peak_within(row["peak_bytes"], peak, f"{row['arch']} {kind}")
        out[kind] = dict(arch=row["arch"], shape=row["shape"],
                         batch=plan.shape.global_batch,
                         seq_len=plan.shape.seq_len,
                         predicted_peak_gb=row["peak_bytes"] / 1e9,
                         peak_gb=peak / 1e9, peak_rel_diff=rel,
                         seconds=seconds, launches=launches,
                         predicted_flops=row["flops_per_chip"])
        del args, logits
        torch.cuda.empty_cache()
    return out, counts


# -- phase 30: the sharded engine ----------------------------------------------

SHARD_ROUNDS = 5
SHARD_STEPS = 3
SHARD_PAPER = dict(n=10, d_s=PAPER["d_s"])  # circulant, DOutGraph(10, 2)


def shard_world(tmp: str):
    """30a's world: one rank on the card, NCCL, its store a file in ``tmp``
    (no network); the ("data", "model") = (1, 1) mesh over it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    return make_host_mesh(device_type="cuda")


def shard_collectives(schedule: str, rounds: int, *, partpsp: bool = False,
                      buffers: int = 1) -> dict:
    """The c10d calls a one-rank run of ``rounds`` issues, as
    ``engine/shard.py`` is written: a dense or sparse round all-gathers
    each packed buffer and ``a``; a circulant roll has no peer and
    exchanges nothing; every round all-reduces its five node reductions
    (seven under PartPSP); no round here is a sync round."""
    out = {"all-reduce": rounds * (7 if partpsp else 5)}
    if schedule != "circulant":
        out["all-gather"] = rounds * (buffers + 1)
    return out


def shard_launches(schedule: str, rounds: int) -> dict:
    """A run's exact launches: the eps norm each round and s's at round 0,
    a perturbation each round, the schedule's mix each round."""
    mix = {"dense": "pushsum_mix", "sparse": "spmm"}.get(schedule)
    out = {"l1_norm_rows": rounds + 1, "dpps_perturb_rows": rounds}
    if mix is not None:
        out[mix] = rounds
    return out


def require_exact(launches: dict, want: dict, where: str) -> None:
    got = {k: v for k, v in launches.items() if v}
    require(got == want, f"{where}: launches {got}, expected {want}")


def shard_consensus(torch, T, ops, dev, mesh, *, topo, shape: dict,
                    schedule: str, label: str) -> tuple[dict, dict]:
    """30a: ``shard_run_dpps`` over the one rank's block (every node) against
    ``run_dpps`` of the same state, ``SHARD_ROUNDS`` noised rounds: ``s``,
    ``a``, the sensitivity state and rows bit for bit; ms a round beside
    the engine's, each after an untimed round (the sharded one also opens
    the communicator, and its c10d calls are counted: a round's exactly);
    the launches of the timed runs exactly; the
    sharded run's peak beside its reckoning: six (N, d_pad) f32 buffers
    (the state the caller holds, the zero perturbation, and in a round
    the last round's state, the noised buffer, the gathered copy and the
    mix's output). The sharded run goes first and its final state is kept
    for the comparison, so the engine's run holds six buffers too (held
    at seven, near the card's capacity, the dense full width's rounds
    took 1.86 s, not 28 ms, on an H100 80GB HBM3 at 700 W)."""
    from repro_torch import engine
    from repro_torch.core.dpps import DPPSConfig, dpps_init
    from repro_torch.launch.op_analysis import CollectiveCount
    from repro_torch.launch.sharding import shard_rows

    n, d_s = shape["n"], shape["d_s"]
    d_pad = d_pad_of(d_s)
    c_prime, lam = T.calibrate_constants(topo)
    b = 1.0
    gamma_n = 0.5 * (1.0 / lam - 1.0) * b / (2.0 * c_prime * d_s)
    plan = engine.ProtocolPlan.from_topology(topo, schedule=schedule,
                                             mesh=mesh)
    require(plan.use_kernels and plan.schedule == schedule,
            f"{label}: the plan did not pick the card's kernels")
    cfg = DPPSConfig(b=b, gamma_n=gamma_n, c_prime=c_prime, lam=lam)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    state = dpps_init({"shared": torch.randn((n, d_s), generator=gen,
                                             device=dev)},
                      plan.resolve_dpps(cfg))
    kw = dict(cfg=cfg, plan=plan, seed=SEED)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3 / SHARD_ROUNDS

    def retries():
        return torch.cuda.memory_stats().get("num_alloc_retries", 0)

    # one untimed round, which opens the communicator, under the count of
    # collectives (a dispatch mode: kept off the timed runs)
    count = CollectiveCount()
    with count:
        engine.shard_run_dpps(mesh, shard_rows(state, mesh), None, rounds=1,
                              **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r0 = retries()
    ops.reset_launch_counts()
    (sh, traj), shard_ms = timed(lambda: engine.shard_run_dpps(
        mesh, shard_rows(state, mesh), None, rounds=SHARD_ROUNDS, **kw))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shard_retries = retries() - r0
    launches = ops.launch_counts()
    engine.run_dpps(state, None, rounds=1, **kw)  # untimed, as above
    ops.reset_launch_counts()
    r0 = retries()
    (single, straj), engine_ms = timed(lambda: engine.run_dpps(
        state, None, rounds=SHARD_ROUNDS, **kw))
    engine_retries = retries() - r0
    engine_launches = ops.launch_counts()
    want = shard_launches(schedule, SHARD_ROUNDS)
    require_exact(launches, want, label)
    require_exact(engine_launches, want, f"{label} (engine)")
    calls = dict(count.calls)
    want_calls = shard_collectives(schedule, 1)
    require(calls == want_calls,
            f"{label}: collectives a round {calls}, expected {want_calls}")
    equal = {
        "s": torch.equal(sh.push.s["shared"], single.push.s["shared"]),
        "a": torch.equal(sh.push.a, single.push.a),
        "s_local": torch.equal(sh.sens.s_local, single.sens.s_local),
        "prev_noise_l1": torch.equal(sh.sens.prev_noise_l1,
                                     single.sens.prev_noise_l1)}
    for k in ("sensitivity_used", "sensitivity_estimate", "eps_l1_max",
              "a_min", "a_max"):
        equal[k] = torch.equal(traj[k], straj[k])
    require(all(equal.values()), f"{label}: sharded != engine: {equal}")
    require("sensitivity_local" not in traj, f"{label}: per-node series")
    finite = bool(torch.isfinite(sh.push.s["shared"]).all())
    require(finite, f"{label}: state not finite")
    gathered = 4.0 * n * d_pad
    out = dict(part=label, n=n, d_s=d_s, d_pad=d_pad, schedule=schedule,
               rounds=SHARD_ROUNDS, gamma_n=gamma_n, bit_equal=equal,
               ms_per_round=shard_ms, engine_ms_per_round=engine_ms,
               all_gather_gb_per_round=(2 * gathered + 8 * n) / 1e9
               if schedule != "circulant" else 0.0,
               collectives_a_round=calls,
               collectives_a_round_predicted=want_calls,
               collective_bytes_a_round=dict(count.bytes),
               peak_mem_gb=peak_gb,
               peak_reckoned_gb=(6 * 4.0 * n * d_pad / 1e9
                                 if schedule != "circulant" else None),
               alloc_retries=dict(shard=shard_retries, engine=engine_retries),
               launches=launches)
    del state, single, sh
    torch.cuda.empty_cache()
    return out, launches


def shard_training(torch, api, mlp, data, T, ops, mesh) -> tuple[dict, dict]:
    """30a: ``shard_run_partpsp`` on the paper MLP (N = 10, 2-out, dense,
    ``SHARD_STEPS`` steps) against ``run_partpsp``: the shared and local
    leaves, ``a`` and the sensitivity state bit for bit."""
    from repro_torch import engine
    from repro_torch.core.tree_utils import tree_leaves
    from repro_torch.launch.op_analysis import CollectiveCount
    from repro_torch.launch.sharding import shard_rows

    batches = training_batches(mlp, data, torch, 10, SHARD_STEPS)
    session, batch_at = training_setup(api, mlp, torch, None,
                                       topo=T.DOutGraph(10, 2),
                                       schedule="dense", batches=batches)
    require(session.plan.use_kernels, "shard training: no kernels")
    kw = dict(cfg=session.train_cfg, partition=session.partition,
              loss_fn=session.loss_fn, plan=session.plan,
              rounds=SHARD_STEPS, seed=session.seed)
    state0 = session.train_state()
    single, _ = engine.run_partpsp(state0, batch_at, **kw)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    count = CollectiveCount()
    t0 = time.perf_counter()
    with count:
        sh, traj = engine.shard_run_partpsp(
            mesh, shard_rows(state0, mesh),
            lambda t: shard_rows(batch_at(t), mesh), **kw)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / SHARD_STEPS
    launches = ops.launch_counts()
    want = dict(shard_launches("dense", SHARD_STEPS))
    require_exact(launches, want, "shard training")
    calls = dict(count.calls)
    want_calls = shard_collectives("dense", SHARD_STEPS, partpsp=True)
    require(calls == want_calls,
            f"shard training: collectives {calls}, expected {want_calls}")
    pairs = list(zip(tree_leaves(sh), tree_leaves(single)))
    equal = all(torch.equal(x, y) for x, y in pairs
                if isinstance(x, torch.Tensor))
    require(equal, "shard training: sharded != engine")
    require("loss_per_node" not in traj, "shard training: per-node series")
    return dict(part="paper_mlp", n=10, d_s=session.partition.d_shared(),
                steps=SHARD_STEPS, bit_equal=equal,
                leaves_compared=sum(isinstance(x, torch.Tensor)
                                    for x, _ in pairs),
                ms_per_step=ms, collectives=calls,
                collectives_predicted=want_calls, launches=launches,
                loss_mean=[float(x) for x in traj["loss_mean"]]), launches


def dout_w(torch, n: int, dev):
    """W of the 2-out graph, as phase 2 builds it."""
    w = torch.zeros((n, n), device=dev)
    for i in range(n):
        for k in range(2):
            w[(i + k) % n, i] += 0.5
    return w


def row_block_mix(torch, ops, ref, dev, *, n: int, d: int, ranks: int,
                  label: str) -> dict:
    """30b: ``pushsum_mix`` with W's (B, N) row blocks, B = N / ranks, each
    the same rows of the full launch bit for bit; one block against its
    plain version, timed beside its bound and ``torch.matmul``."""
    w = dout_w(torch, n, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + n)
    x = torch.randn((n, d), generator=gen, device=dev)
    full = ops.pushsum_mix(w, x)
    b = n // ranks
    blocks = [w[r * b:(r + 1) * b] for r in range(ranks)]
    equal = all(torch.equal(ops.pushsum_mix(wb, x), full[r * b:(r + 1) * b])
                for r, wb in enumerate(blocks))
    require(equal, f"{label}: a row block differs from the full launch")
    del full
    wb = blocks[-1]
    # rtol 1e-5 / atol 1e-6: fma in j order against cuBLAS's order
    err, ok = compare(ops.pushsum_mix(wb, x), ref.pushsum_mix(wb, x),
                      rtol=1e-5, atol=1e-6)
    require(ok, f"{label}: the block disagrees with plain: {err}")
    flops, nbytes = ops.kernel_cost("pushsum_mix", n=n, d=d, b=b)
    out = dict(n=n, d=d, b=b, ranks=ranks, equals_full_rows=equal,
               max_abs_err=err,
               plan=ops.mix_plan(n, d, torch.cuda.get_device_properties(
                   dev).multi_processor_count, rows=b),
               ms=cuda_ms(torch, lambda: ops.pushsum_mix(wb, x), 5),
               plain_ms=cuda_ms(torch, lambda: ref.pushsum_mix(wb, x), 3),
               library_ms=cuda_ms(torch, lambda: torch.matmul(wb, x), 3),
               bound=bound(nbytes, f32_ops=flops))
    del x
    torch.cuda.empty_cache()
    return out


def row_block_spmm(torch, ops, ref, dev, *, topo, d: int, ranks: int) -> dict:
    """30b: ``spmm`` with (B, K) row blocks of the padded CSR, each the
    same rows of the full launch bit for bit; one block against its plain
    version, timed beside its bound (the senders its real edges read, its
    rows written, its slots) and :func:`library_spmm` of its W rows."""
    n = topo.n_nodes
    idx, vals, w, _ = csr_of(torch, topo, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + n)
    x = torch.randn((n, d), generator=gen, device=dev)
    full = ops.spmm(idx, vals, x)
    b = n // ranks
    equal = all(torch.equal(
        ops.spmm(idx[r * b:(r + 1) * b], vals[r * b:(r + 1) * b], x),
        full[r * b:(r + 1) * b]) for r in range(ranks))
    require(equal, "spmm: a row block differs from the full launch")
    del full
    rows = slice((ranks - 1) * b, ranks * b)
    ib, vb = idx[rows], vals[rows]
    # rtol 1e-6 / atol 1e-6: fma against a separate multiply and add
    err, ok = compare(ops.spmm(ib, vb, x), ref.spmm(ib, vb, x), rtol=1e-6,
                      atol=1e-6)
    require(ok, f"spmm: the block disagrees with plain: {err}")
    real = vb > 0
    senders = int(torch.unique(ib[real]).numel())
    edges = int(real.sum())
    k = idx.shape[1]
    library = library_spmm(torch, w[rows], x, ops.spmm(ib, vb, x), 3)
    out = dict(n=n, d=d, b=b, k=k, ranks=ranks, edges=edges,
               senders=senders, equals_full_rows=equal, max_abs_err=err,
               plan=ops.spmm_plan(n, k, d, torch.cuda.get_device_properties(
                   dev).multi_processor_count, rows=b),
               ms=cuda_ms(torch, lambda: ops.spmm(ib, vb, x), 5),
               plain_ms=cuda_ms(torch, lambda: ref.spmm(ib, vb, x), 1),
               **library,
               bound=bound(4.0 * (senders + b) * d + 8.0 * b * k,
                           f32_ops=2.0 * edges * d))
    del x
    torch.cuda.empty_cache()
    return out


def row_block_perturb(torch, ops, ref, dev, *, shape: dict, ranks: int,
                      label: str) -> dict:
    """30b: the perturbation of rows [node0, node0 + B), node0 > 0 (the
    last rank's block): the same rows of the full launch bit for bit, its
    Philox keyed by global node; against its plain version over column
    windows (its Philox temporaries would not fit whole), timed beside its
    bound and the copy yardstick."""
    n, d_s = shape["n"], shape["d_s"]
    d_pad = d_pad_of(d_s)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s = torch.randn((n, d_pad), generator=gen, device=dev)
    eps = torch.randn((n, d_pad), generator=gen, device=dev).mul_(0.1)
    s[:, d_s:] = 0.0
    eps[:, d_s:] = 0.0
    scale, gamma_n, t = torch.tensor(0.7, device=dev), 0.1, 3
    full = ops.dpps_perturb_rows(s, eps, scale, gamma_n, d_s, seed=SEED, t=t)
    b = n // ranks
    node0 = (ranks - 1) * b
    rows = slice(node0, node0 + b)
    sb, eb = s[rows], eps[rows]
    got = ops.dpps_perturb_rows(sb, eb, scale, gamma_n, d_s, seed=SEED, t=t,
                                node0=node0)
    equal = all(torch.equal(g, f[rows]) for g, f in zip(got, full))
    require(equal, f"{label}: the block's draw differs from the full rows")
    del full
    err, events, cols = 0.0, [], 1 << 25
    for c0 in range(0, d_s, cols):
        c1 = min(d_s, c0 + cols)
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        p_out, _, _ = ref.dpps_perturb_rows(
            sb[:, c0:c1], eb[:, c0:c1], scale, gamma_n, c1 - c0,
            bits=ref.philox_bits(SEED, t, b, c0, c1, device=dev,
                                 node0=node0).to(torch.uint32))
        ev1.record()
        events.append((ev0, ev1))
        diff = (got[0][:, c0:c1] - p_out).abs()
        err = max(err, diff.max().item())
        # rtol 1e-6 / atol 1e-6: the card's logf may differ by an ulp
        require(bool((diff <= 1e-6 + 1e-6 * p_out.abs()).all()),
                f"{label}: the block disagrees with plain at [{c0}, {c1})")
        del p_out, diff
    torch.cuda.synchronize()
    out = dict(n=n, d_s=d_s, b=b, node0=node0, ranks=ranks,
               equals_full_rows=equal, max_abs_err=err,
               plan=ops.perturb_plan(b, d_pad),
               ms=cuda_ms(torch, lambda: ops.dpps_perturb_rows(
                   sb, eb, scale, gamma_n, d_s, seed=SEED, t=t,
                   node0=node0), 5),
               plain_ms=sum(a.elapsed_time(z) for a, z in events),
               library_ms=None, copy_ms=copy_ms(torch, sb, eb, 5),
               bound=perturb_bound(b, d_s, d_pad))
    del s, eps, got
    torch.cuda.empty_cache()
    return out


def shard_phase(torch, api, mlp, data, T, ops, ref, dev) -> tuple:
    """Phase 30: (a) the sharded engine over a one-rank NCCL world against
    the single-card engine; (b) the changed kernels at the row blocks a
    world of several ranks would launch. -> (emitted dict, 30a's launch
    counts, 30b's entries by kernel)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    out, counts = dict(phase="shard"), []
    with tempfile.TemporaryDirectory() as tmp:
        mesh = shard_world(tmp)
        try:
            for label, topo, shape, schedule in (
                    ("dense_full", T.DOutGraph(FULL["n"], 2), FULL, "dense"),
                    ("sparse_full", sparse_graph(SPARSE_FULL["n"]),
                     SPARSE_FULL, "sparse"),
                    ("circulant_paper", T.DOutGraph(SHARD_PAPER["n"], 2),
                     SHARD_PAPER, "circulant")):
                out[label], c = shard_consensus(
                    torch, T, ops, dev, mesh, topo=topo, shape=shape,
                    schedule=schedule, label=label)
                counts.append(c)
            out["paper_mlp"], c = shard_training(torch, api, mlp, data, T,
                                                 ops, mesh)
            counts.append(c)
        finally:
            dist.destroy_process_group()
    blocks = {
        "pushsum_mix": {
            "row_block_full_shape": row_block_mix(
                torch, ops, ref, dev, n=FULL["n"], d=d_pad_of(FULL["d_s"]),
                ranks=FULL["n"], label="mix, dense full width"),
            "row_block_training_shape": row_block_mix(
                torch, ops, ref, dev, n=TRAIN_FULL["n"],
                d=d_pad_of(TRAIN_FULL["d_s"]), ranks=TRAIN_FULL["n"],
                label="mix, training shape")},
        "spmm": {"row_block_sparse_full_shape": row_block_spmm(
            torch, ops, ref, dev, topo=sparse_graph(SPARSE_FULL["n"]),
            d=d_pad_of(SPARSE_FULL["d_s"]), ranks=4)},
        "dpps_perturb_rows": {
            "row_block_full_shape": row_block_perturb(
                torch, ops, ref, dev, shape=FULL, ranks=FULL["n"],
                label="perturbation, dense full width"),
            "row_block_sparse_full_shape": row_block_perturb(
                torch, ops, ref, dev, shape=SPARSE_FULL, ranks=4,
                label="perturbation, sparse full width")}}
    out["row_blocks"] = {k: {s: dict(r, bound_ms=r["bound"][0],
                                     bound_by=r["bound"][1])
                             for s, r in v.items()}
                         for k, v in blocks.items()}
    out["seconds"] = time.perf_counter() - t0
    return out, counts, blocks


# -- phase 31: the model axis (tensor and expert parallelism for serving) ------

# 31b's runs: arch, layers kept (None: all), prompt, greedy decode steps.
# llama4-scout keeps one MoE layer of its 48 (~17 GB of f32 weights whole,
# ~8.6 GB a rank at M = 2).
TP_RUNS = {
    "llama": dict(arch="llama3.2-1b", layers=None, prompt=4096, steps=16),
    "scout": dict(arch="llama4-scout-17b-a16e", layers=1, prompt=1024,
                  steps=8),
}
TP_RANKS = 2
TP_WARMUP_STEPS = 1
# Logits of the sharded run against the unsharded one: atol 1e-4 (only
# the 2-way split of the wo / w_down sums changes an order). A greedy
# token cannot flip within that where every top-1 logit margin of the
# unsharded run is above twice it; MoE routing cannot where every top-1
# router-probability margin is above 1e-5 (the router's input differs by
# ~1e-6 relative). The data seed is the first of TP_SEED_TRIES that gives
# the unsharded run those margins.
TP_ATOL = 1e-4
TP_LOGIT_MARGIN = 2 * TP_ATOL
TP_ROUTE_MARGIN = 1e-5
TP_SEED_TRIES = 8
TP_JOIN_S = 600


def tp_config(run: dict):
    """(ArchSpec, ModelConfig) of a 31b or 33 run: the published width, its
    one group cut to ``layers`` (31b) or by the fields of ``cut`` (33;
    None: whole)."""
    import dataclasses

    from repro_torch.configs import get_config

    spec = get_config(run["arch"])
    cfg = spec.model
    cut = run.get("cut") or ({} if run.get("layers") is None
                             else dict(n_layers=run["layers"]))
    if cut:
        (group,) = cfg.groups
        cfg = dataclasses.replace(cfg, groups=(
            dataclasses.replace(group, **cut),))
    return dataclasses.replace(spec, model=cfg), cfg


def tp_collectives(cfg, b: int, s: int) -> dict:
    """The c10d calls and operand bytes a step of ``b`` sequences of ``s``
    new positions issues on a rank of the model axis (any M, a data dim of
    1), as ``models/parallel.py`` is written: an all-reduce of the (b, s,
    d) activations after each layer's wo and its w_down (or MoE combine),
    one after the embedding lookup, one of the (b, V) logits."""
    layers = sum(g.n_layers for g in cfg.groups)
    act = 4 * b * s * cfg.d_model
    return {"all-reduce": [2 * layers + 2,
                           (2 * layers + 1) * act + 4 * b * cfg.vocab_size]}


class C10dCount:
    """Counts the c10d calls and operand bytes made through
    ``torch.distributed``'s ``all_reduce`` and all-gathers while it is on,
    by the reference's kind (the port calls them as module attributes):
    one wrapper a call, where ``CollectiveCount``'s dispatch mode costs
    host time an op (it doubled a host-bound xlstm training step, phase
    33)."""

    KINDS = {"all_reduce": "all-reduce", "all_gather": "all-gather",
             "all_gather_into_tensor": "all-gather"}

    def __enter__(self):
        import torch.distributed as dist

        self.calls, self.bytes, self._saved = {}, {}, {}
        for name, kind in self.KINDS.items():
            fn = self._saved[name] = getattr(dist, name)

            def counted(*args, _fn=fn, _kind=kind, _name=name, **kw):
                x = args[1] if _name != "all_reduce" else args[0]
                self.calls[_kind] = self.calls.get(_kind, 0) + 1
                self.bytes[_kind] = self.bytes.get(_kind, 0) + (
                    x.numel() * x.element_size())
                return _fn(*args, **kw)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        return False


def tp_serve(torch, ops, dev, run: dict, mesh, data_seed: int) -> dict:
    """A prefill of ``run["prompt"]`` tokens and ``run["steps"]`` greedy
    decode steps through ``build_serve_plan(arch, mesh)`` (None: the
    unsharded plan) on this process's card, the weights the model's draw
    from SEED (over a model axis, the rank's shard of it), the prompt
    (and a VLM's image embeddings, passed to every step) from
    ``data_seed``. A warm-up of the same prompt and TP_WARMUP_STEPS
    decode steps first (a process's first prefill at a new size took
    seconds on the card), its c10d calls counted (``C10dCount``; the
    timed run goes without it); the launch counts are set to 0 just
    before the timed prefill and read after the decode. -> CPU copies of the logits and
    tokens, the times, the warm-up's c10d calls a step (prefill, then
    each decode step), the launches, the peak beside its reckoning, and
    the top-1 margins (logits, MoE routing)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.core.tree_utils import tree_leaves
    from repro_torch.launch.steps import build_serve_plan
    from repro_torch.models import moe

    arch, cfg = tp_config(run)
    s, steps = run["prompt"], run["steps"]
    plans = {kind: build_serve_plan(arch, mesh, shape_name=kind,
                                    shape=ShapeSpec(kind, n, 1, kind))
             for kind, n in (("prefill", s), ("decode", s + steps))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = plans["prefill"].init_args(dev, seed=SEED)[0]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_bytes = sum(x.numel() * x.element_size()
                      for x in tree_leaves(params))
    route, margins = moe.moe_route, []
    # a cross-attention model's image embeddings, drawn below: [enc]
    vlm, enc = any(g.kind == "cross_self" for g in cfg.groups), []

    def recorded(router, tokens, n_experts, cap):
        r = route(router, tokens, n_experts, cap)
        top2 = r["probs"].topk(2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).min())
        return r

    def generate(tokens, n: int, calls=None):
        def counted(fn, *args, **kw):
            if calls is None:
                return fn(*args, **kw)
            count = C10dCount()
            with count:
                out = fn(*args, **kw)
            calls.append({k: [count.calls[k], count.bytes[k]]
                          for k in count.calls})
            return out

        p = tokens.shape[1]
        batch = {"tokens": tokens}
        if enc:
            batch["image_embeds"] = enc[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = counted(plans["prefill"].step_fn, params, batch,
                                capacity=p + n)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = [logits]
        for i in range(n):
            tok = out[-1].argmax(dim=-1)
            logits, cache = counted(plans["decode"].step_fn, params, cache,
                                    tok, p + i, *enc)
            out.append(logits)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        kv = sum(x.numel() * x.element_size() for x in tree_leaves(cache))
        return out, (t1 - t0) * 1e3, (t2 - t1) * 1e3 / max(n, 1), kv

    gen = torch.Generator(device=dev).manual_seed(data_seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                           device=dev)
    if vlm:  # normal x 0.1, drawn after the prompt
        (group,) = cfg.groups
        enc.append(torch.randn((1, group.n_image_tokens, cfg.d_model),
                               generator=gen, device=dev).mul_(0.1))
    calls = []
    generate(tokens, TP_WARMUP_STEPS, calls)
    moe.moe_route = recorded
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        logits, prefill_ms, decode_ms, kv = generate(tokens, steps)
        launches = ops.launch_counts()
    finally:
        moe.moe_route = route
    peak = torch.cuda.max_memory_allocated()
    stacked = torch.cat(logits).float()
    top2 = stacked.topk(2, dim=-1).values
    return dict(
        logits=stacked.cpu(), tokens=stacked.argmax(dim=-1).cpu(),
        prefill_ms=prefill_ms, decode_ms_per_step=decode_ms, init_s=init_s,
        calls=calls, launches=launches, peak_gb=peak / 1e9,
        params_gb=param_bytes / 1e9, cache_gb=kv / 1e9,
        reckoned_gb=(param_bytes + kv) / 1e9,
        logit_margin=(top2[:, 0] - top2[:, 1]).min().item(),
        routing_margin=min(m.item() for m in margins) if margins else None,
        data_seed=data_seed, prompt=s, steps=steps,
        layers=cfg.total_layers, heads=(cfg.n_heads, cfg.n_kv_heads))


def tp_flash_check(torch, ops, ref, dev, cfg, s: int, m: int,
                   rank: int) -> dict:
    """One flash launch at rank ``rank``'s head run of ``cfg`` (its query
    heads, whole heads whatever H / M, and the KV heads they read: a
    ``ModelAxis.attn_heads`` share, its head offset ``off`` into its first
    KV head's group) against the plain version at that shape and offset,
    random q, k, v; atol 1e-5 + rtol 1e-4, as phase 9. A rank without heads
    launches nothing."""
    from repro_torch.models.parallel import ModelAxis

    share = ModelAxis(size=m, rank=rank).attn_heads(cfg.n_heads,
                                                    cfg.n_kv_heads)
    h, kh, d = share.h, share.kv, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + rank)
    q = torch.randn((1, s, h, d), generator=gen, device=dev)
    k = torch.randn((1, s, kh, d), generator=gen, device=dev)
    v = torch.randn((1, s, kh, d), generator=gen, device=dev)
    shape = dict(b=1, s=s, h=h, kh=kh, d=d, window=None, head0=share.off,
                 group=share.group)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention_bshd(q, k, v, group=share.group,
                                   head0=share.off)
    launched = ops.launch_counts()["flash_attention"] - before
    require(launched == (1 if h else 0),
            f"flash_attention launched {launched} times at rank {rank}'s "
            f"share {shape}")
    if not h:
        return dict(shape=shape, max_abs_err=0.0, launched=0)
    want = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), group=share.group,
                               head0=share.off).transpose(1, 2)
    diff = (got - want).abs()
    require(bool((diff <= 1e-5 + 1e-4 * want.abs()).all()),
            f"flash_attention disagrees at rank {rank}'s shard {shape}: "
            f"max abs err {diff.max().item()}")
    return dict(shape=shape, max_abs_err=diff.max().item(), launched=1)


def tp_rank(torch, ops, ref, dev, *, rank: int, store: str, out: str,
            seeds: dict) -> None:
    """31b's rank ``rank`` (``chip_smoke.py --tp-rank JSON``): a gloo world
    of TP_RANKS processes on the one card (gloo all-reduces CUDA tensors,
    staged through the host; NCCL refuses two ranks on one device), the
    ("data", "model") = (1, TP_RANKS) mesh; each of TP_RUNS through
    ``tp_serve`` and the flash launch at its shard; the results saved to
    ``out``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=TP_RANKS,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_host_mesh(shape=(1, TP_RANKS))
        result = {}
        for name, run in TP_RUNS.items():
            result[name] = tp_serve(torch, ops, dev, run, mesh, seeds[name])
            result[name]["flash_check"] = tp_flash_check(
                torch, ops, ref, dev, tp_config(run)[1],
                run["prompt"], TP_RANKS, rank)
            torch.cuda.empty_cache()
        torch.save(result, out)
    finally:
        dist.destroy_process_group()


def tp_reference(torch, ops, dev, run: dict) -> dict:
    """The unsharded run at the first data seed whose logit and routing
    margins hold (TP_SEED_TRIES tries)."""
    for data_seed in range(SEED, SEED + TP_SEED_TRIES):
        r = tp_serve(torch, ops, dev, run, None, data_seed)
        torch.cuda.empty_cache()
        if r["logit_margin"] > TP_LOGIT_MARGIN and (
                r["routing_margin"] is None
                or r["routing_margin"] > TP_ROUTE_MARGIN):
            return r
    raise AssertionError(f"{run['arch']}: no data seed in {TP_SEED_TRIES} "
                         "gives the top-1 margins")


def tp_summary(r: dict) -> dict:
    return {k: v for k, v in r.items() if k not in ("logits", "tokens")}


def model_axis_phase(torch, ops, ref, dev, smi: str) -> tuple:
    """Phase 31: (a) llama3.2-1b at full width through ``build_serve_plan(
    arch, mesh)`` on a one-rank NCCL world's (1, 1) mesh, bit for bit the
    unsharded plan; (b) llama3.2-1b and llama4-scout (one MoE layer) at
    full width over a 2-rank gloo world on the one card, against the
    unsharded plan on the same weights. -> (emitted dict, the main paths'
    launch counts, each rank's flash checks)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    out = dict(phase="model_axis", card=smi, note=(
        "31b's times are two ranks sharing one card's SMs, their "
        "all-reduces gloo's, staged through the host: not speed figures "
        "of tensor parallelism, which wait for a cell of several cards"))
    counts = []
    refs = {name: tp_reference(torch, ops, dev, run)
            for name, run in TP_RUNS.items()}
    with tempfile.TemporaryDirectory() as tmp:
        mesh = shard_world(tmp)
        try:
            one = tp_serve(torch, ops, dev, TP_RUNS["llama"], mesh,
                           refs["llama"]["data_seed"])
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    want = refs["llama"]
    _, cfg = tp_config(TP_RUNS["llama"])
    require(torch.equal(one["logits"], want["logits"]),
            "31a: the one-rank model axis is not the unsharded plan bit for "
            "bit")
    calls = [tp_collectives(cfg, 1, want["prompt"])] + \
        [tp_collectives(cfg, 1, 1)] * TP_WARMUP_STEPS
    require(one["calls"] == calls,
            f"31a: c10d calls {one['calls'][:2]}, expected {calls[:2]}")
    require(one["launches"]["flash_attention"] == cfg.total_layers,
            f"31a: flash launches {one['launches']}")
    counts.append(one["launches"])
    out["a"] = dict(tp_summary(one), bit_for_bit=True,
                    unsharded=tp_summary(want))

    with tempfile.TemporaryDirectory() as tmp:
        seeds = {name: r["data_seed"] for name, r in refs.items()}
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--tp-rank",
             json.dumps(dict(rank=rank, store=f"{tmp}/store",
                             out=f"{tmp}/rank{rank}.pt", seeds=seeds))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(TP_RANKS)]
        try:
            logs = [p.communicate(timeout=TP_JOIN_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, (_, err)) in enumerate(zip(procs, logs)):
            require(p.returncode == 0,
                    f"31b rank {rank} exited {p.returncode}: {err[-4000:]}")
        ranks = [torch.load(f"{tmp}/rank{rank}.pt", weights_only=False)
                 for rank in range(TP_RANKS)]
    out["b"], flash_checks = {}, []
    for name, run in TP_RUNS.items():
        want = refs[name]
        _, cfg = tp_config(run)
        calls = [tp_collectives(cfg, 1, run["prompt"])] + \
            [tp_collectives(cfg, 1, 1)] * TP_WARMUP_STEPS
        for rank, r in enumerate(ranks):
            got = r[name]
            require(torch.equal(got["logits"], ranks[0][name]["logits"]),
                    f"31b {name}: rank {rank}'s logits differ from rank 0's")
            err = (got["logits"] - want["logits"]).abs().max().item()
            require(err <= TP_ATOL,
                    f"31b {name}: rank {rank} logits max abs err {err}")
            require(torch.equal(got["tokens"], want["tokens"]),
                    f"31b {name}: rank {rank}'s greedy tokens differ")
            require(got["calls"] == calls,
                    f"31b {name}: rank {rank} c10d calls {got['calls'][:2]}, "
                    f"expected {calls[:2]}")
            require(got["launches"]["flash_attention"] == cfg.total_layers,
                    f"31b {name}: rank {rank} flash launches "
                    f"{got['launches']}")
            require(got["peak_gb"] < want["peak_gb"],
                    f"31b {name}: rank {rank}'s peak {got['peak_gb']} GB is "
                    f"not below the unsharded {want['peak_gb']} GB")
            counts.append(got["launches"])
            got["max_abs_err"] = err
            flash_checks.append(dict(got["flash_check"], rank=rank, run=name,
                                     launches=got["launches"][
                                         "flash_attention"]))
        out["b"][name] = dict(
            unsharded=tp_summary(want),
            ranks=[tp_summary(r[name]) for r in ranks], ranks_bit_equal=True,
            tolerance=dict(atol=TP_ATOL, logit_margin=TP_LOGIT_MARGIN,
                           routing_margin=TP_ROUTE_MARGIN))
    out["seconds"] = time.perf_counter() - t0
    return out, counts, flash_checks


# -- phase 32: training over the model axis ------------------------------------

# 32b: llama3.2-1b at full width over TP_RANKS gloo ranks on the one card
# (M = 2), N = 4 nodes of one 256-token sequence (cut from 512 for the
# script's time limit with phase 34), 2 steps, against the
# unsharded TrainPlan on the same weights and Philox bits, run first in
# this process and freed before the ranks start. Reckoned peaks (f32, the
# step's largest buffers): unsharded, the state (19.8 GB), the updated
# local leaves and their gradients (15.9 GB each) and y (3.9 GB), ~56 GB;
# a rank half of each, ~28 GB, the two ~57 GB together: under 70 GB of
# the card, so N stays 4.
TRAIN_TP = dict(arch="llama3.2-1b", n=4, per_node_batch=1, seq_len=256,
                steps=2)
# the loss within 1e-5 relative and every leaf within atol 1e-4 of the
# unsharded run's (only the order of the model axis's sums differs); a
# leaf is compared at a stride over the rank's shard, at most
# TRAIN_TP_SAMPLE of its elements (a leaf of no more whole), and its L1
# norm within TRAIN_TP_NORM_RTOL
TRAIN_TP_LOSS_RTOL = 1e-5
TRAIN_TP_ATOL = 1e-4
TRAIN_TP_SAMPLE = 1 << 24
TRAIN_TP_NORM_RTOL = 1e-5
TRAIN_TP_JOIN_S = 600
# 32c: llama4-scout at one MoE layer of its 48 (phase 19's run d), one
# node's loss and backward over every parameter at M = 2; the data seed
# the first of TP_SEED_TRIES whose every top-1 router margin in the
# unsharded pass is above TP_ROUTE_MARGIN (31b's rule)
# the strided perturbation: a rank's block [a, b) of the last dim of a
# (lead, width) leaf at wire column col0; run, off and col0 not multiples
# of 4 (a quad straddles Philox counters), runs of 11 (quads across run
# ends), long rows (several blocks a row)
STRIDED_MAPS = ((6, 10, 3, 8, 5), (1000, 33, 11, 22, 1),
                (3, 100_003, 7, 100_000, 2))
# the main path's largest strided leaf: rank 0's half of the columns of
# llama3.2-1b's shared w_up ((4, 2048, 8192) a node: lead 4 x 2048, width
# 8192), N = 4, at its column in the wire row (after wk, wo, wq, wv, the
# two norm scales, w_down and w_gate of the four shared layers)
STRIDED_MAIN = (4, 4 * 2048, 8192, 0, 4096, 176_177_152)


def state_digests(torch, leaves, chunk: int = 1 << 26) -> list:
    """Each tensor's 32-bit words as two int64 sums (modulo 2^64): plain,
    and weighted by position % 65521 + 1; a digest of its bits, taken on
    its device in chunks."""
    out = []
    for x in leaves:
        flat = x.detach().contiguous().reshape(-1).view(torch.int32)
        total = torch.zeros((), dtype=torch.int64, device=x.device)
        weighted = torch.zeros_like(total)
        for c0 in range(0, flat.numel(), chunk):
            part = flat[c0:c0 + chunk].to(torch.int64)
            pos = torch.arange(c0, c0 + part.numel(), device=x.device)
            total += part.sum()
            weighted += (part * (pos % 65521 + 1)).sum()
        out.append([int(total), int(weighted)])
    return out


def train_pass_collectives(cfg, seq: int, m: int) -> int:
    """The all-reduces of one node's loss and backward on a rank of the
    model axis where no KV head is shared (M <= K), as the code is
    written: one after the embedding, two a layer (after wo, after w_down
    or the MoE combine) and, at M > 1, three a 512-position loss chunk
    (its max, its exponentials' sum, its target's logit); the backward's
    recomputation of each layer's first and, at M > 1, each chunk's first
    two; the copy-to-model sums, two an attention layer, three an MoE
    unit (its attention's input, its experts' tokens, its gate
    probability), one a chunk's head."""
    layers = sum(g.n_layers for g in cfg.groups)
    units = sum(g.n_layers for g in cfg.groups if g.kind == "moe")
    chunks = -(-(seq - 1) // 512)
    return ((cfg.input_mode == "tokens") + 5 * layers + units + chunks
            + (5 * chunks if m > 1 else 0))


def train_collectives(cfg, nodes: int, seq: int, m: int, t: int) -> dict:
    """A rank's PartPSP round t over ``nodes`` node rows (a data dim of 1):
    two passes a node, and the per-node norms finished over "model" (the
    perturbation's, the noise's, the clip's; s^(0)'s at round 0)."""
    return {"all-reduce": 2 * nodes * train_pass_collectives(cfg, seq, m)
            + 3 + (t == 0)}


def lm_steps(torch, dev, plan, steps: int, count=None) -> tuple:
    """``steps`` steps of a TRAIN_LM plan from the seeded init on 29b's
    batch (seeds SEED, SEED + 1, ...), the first under ``count`` (a
    ``CollectiveCount``) where one is given -> (digests of the final
    state's leaves, the last step's ms, its loss)."""
    state = plan.init_state(dev, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    batch = {"tokens": torch.randint(
        0, plan.model.cfg.vocab_size, tuple(plan.batch_specs["tokens"].shape),
        generator=gen, device=dev, dtype=torch.int32)}
    for t in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if t == 0 and count is not None:
            with count:
                state, metrics = plan.step_fn(state, batch, SEED + t)
        else:
            state, metrics = plan.step_fn(state, batch, SEED + t)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    digests = state_digests(torch, state_leaves(torch, state))
    loss = float(metrics["loss_mean"])
    del state, batch, metrics
    torch.cuda.empty_cache()
    return digests, ms, loss


def train_one_rank(torch, ops, dev, lm: dict) -> tuple:
    """32a: 29b's TrainPlan (TRAIN_LM, its gamma_n) unsharded and as rank 0
    of a one-rank NCCL world's (1, 1) mesh, two steps each from the same
    seeded state and batch: the states bit for bit alike (a digest of
    every leaf's bits), the rank's first step's c10d calls the code's
    count (under ``CollectiveCount``; the second timed without it), its
    launches the tree runtime's exact count."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.op_analysis import CollectiveCount
    from repro_torch.launch.steps import build_train_plan

    arch = get_config(TRAIN_LM["arch"])

    def plan_of(mesh):
        plan = build_train_plan(arch, TRAIN_LM["n"] if mesh is None else mesh,
                                nodes=TRAIN_LM["n"],
                                shape=ShapeSpec(**TRAIN_LM_SHAPE))
        plan.cfg = dataclasses.replace(plan.cfg, dpps=dataclasses.replace(
            plan.cfg.dpps, gamma_n=lm["gamma_n"]))
        return plan

    want, whole_ms, _ = lm_steps(torch, dev, plan_of(None), 2)
    count = CollectiveCount()
    with tempfile.TemporaryDirectory() as tmp:
        mesh = shard_world(tmp)
        try:
            plan = plan_of(mesh)
            ops.reset_launch_counts()
            digests, step_ms, loss = lm_steps(torch, dev, plan, 2, count)
            launches = ops.launch_counts()
        finally:
            dist.destroy_process_group()
    leaves = len(plan.partition.split_static(
        [None] * len(plan.partition.leaf_plans()))[0])
    calls = {k: count.calls[k] for k in count.calls}
    want_calls = train_collectives(arch.model, TRAIN_LM["n"],
                                   TRAIN_LM["seq_len"], 1, 0)
    require(digests == want,
            "32a: the one-rank model axis's state after two steps is not "
            "the unsharded plan's bit for bit")
    require(calls == want_calls, f"32a: c10d calls {calls}, expected "
            f"{want_calls}")
    require_exact(launches, {k: v for k, v in tree_launches(
        leaves, 0, 2, plan.cfg.dpps.sync_interval).items() if v},
        "32a training")
    return dict(bit_for_bit=True, steps=2, calls_first_step=calls,
                step_ms=step_ms, unsharded_step_ms=whole_ms,
                phase29b_step_ms=lm["step_ms"], loss=loss,
                launches=launches), launches


def tp_train_plan(mesh, gamma_n: float | None = None):
    """32b's TrainPlan (TRAIN_TP): the unsharded one (mesh None) or a
    rank's; gamma_n half the Remark-1 stability limit of the unsharded
    plan's d_s (as 29b's)."""
    import dataclasses

    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.launch.steps import build_train_plan

    arch = get_config(TRAIN_TP["arch"])
    shape = ShapeSpec("train_tp", TRAIN_TP["seq_len"],
                      TRAIN_TP["n"] * TRAIN_TP["per_node_batch"], "train")
    plan = build_train_plan(arch, TRAIN_TP["n"] if mesh is None else mesh,
                            nodes=TRAIN_TP["n"], shape=shape)
    dpps = plan.cfg.dpps
    if gamma_n is None:
        gamma_n = 0.5 * (1.0 / dpps.lam - 1.0) * dpps.b / (
            2.0 * dpps.c_prime * plan.partition.d_shared())
    plan.cfg = dataclasses.replace(plan.cfg, dpps=dataclasses.replace(
        dpps, gamma_n=gamma_n))
    return plan, gamma_n


def rank_launches(plan, rank: int) -> tuple[dict, int]:
    """The exact launches of rank ``rank``'s TRAIN_TP steps at M = TP_RANKS
    (the tree runtime, a data dim of 1): a norm of each shared leaf whose
    columns the rank counts a step (and of s at round 0), a perturbation
    and a mix of each shared leaf a step; and how many of the
    perturbations draw at strided columns (a leaf split on a dim after its
    first)."""
    from repro_torch.launch.sharding import train_columns
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    steps = TRAIN_TP["steps"]
    axis = ModelAxis(size=TP_RANKS, rank=rank)
    counted, maps = train_columns(Transformer(plan.model.cfg, axis=axis),
                                  plan.partition, axis)
    want = {k: 0 for k in KERNELS}
    want.update(l1_norm_rows=sum(counted) * (steps + 1),
                dpps_perturb_rows=len(maps) * steps,
                pushsum_mix=len(maps) * steps)
    return want, sum(not m.contiguous for m in maps) * steps


def tp_tokens(torch, dev, shape: tuple, vocab: int, seed: int):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, shape, generator=gen, device=dev,
                         dtype=torch.int32)


def shard_samples(torch, named: dict, blocks, ranks: int) -> list:
    """For each of ``ranks`` model ranks, each leaf's shard (``blocks[r]
    [path]``: its (dim, slice) pairs, None whole) as (stride, its elements
    at that stride (on the host), its L1 norm in f64)."""
    from repro_torch.models.parallel import take

    out = []
    for r in range(ranks):
        leaves = {}
        for path, x in named.items():
            shard = take(x.detach(), blocks[r][path])
            flat = shard.reshape(-1)
            k = -(-flat.numel() // TRAIN_TP_SAMPLE)
            leaves[path] = (k, flat[::k].cpu(), float(
                shard.abs().sum(dtype=torch.float64)))
            del shard, flat
        out.append(leaves)
    return out


def samples_agree(torch, named: dict, want: dict) -> dict:
    """A rank's leaves against :func:`shard_samples`' entries: the largest
    error at the sampled elements of the parameter leaves, the largest
    relative error of ``a`` and the (N,) sensitivity vectors (noise norms
    of ~1e9 at full width), the largest relative L1-norm gap."""
    worst, rel, norm_gap, compared = 0.0, 0.0, 0.0, 0
    worst_leaf = None
    require(set(named) == set(want), "the rank's leaves are not the "
            "unsharded run's")
    for path, x in named.items():
        k, sample, norm = want[path]
        got = x.detach().reshape(-1)[::k]
        diff = (got - sample.to(got.device)).abs()
        if path.startswith((".dpps/.push/.a", ".dpps/.sens/")):
            rel = max(rel, (diff / sample.to(got.device).abs()).max().item())
        elif diff.max().item() > worst:
            worst, worst_leaf = diff.max().item(), path
        norm_gap = max(norm_gap, abs(float(x.detach().abs().sum(
            dtype=torch.float64)) - norm) / max(norm, 1e-30))
        compared += got.numel()
    return dict(max_abs_err=worst, worst_leaf=worst_leaf,
                vectors_max_rel_err=rel, max_norm_rel_gap=norm_gap,
                compared=compared, leaves=len(named))


def named_state(torch, state) -> dict:
    from repro_torch.core.tree_utils import tree_flatten_with_path

    return {p: x for p, x in tree_flatten_with_path(state)[0]
            if isinstance(x, torch.Tensor) and x.dim()}


def moe_train_config():
    """32c's (ArchSpec, ModelConfig): llama4-scout at one MoE layer."""
    import dataclasses

    spec, cfg = group_train_config(GROUP_TRAIN_RUNS["d"])
    return dataclasses.replace(spec, model=cfg), cfg


def router_margins(torch, model, params, tokens) -> float:
    """The smallest top-1 router-probability margin of ``model``'s loss
    forward on one node's ``tokens`` (without grad)."""
    from repro_torch.models import moe

    route, margins = moe.moe_route, []

    def recorded(router, toks, n_experts, cap):
        r = route(router, toks, n_experts, cap)
        top2 = r["probs"].topk(2, dim=-1).values
        margins.append((top2[:, 0] - top2[:, 1]).min().item())
        return r

    moe.moe_route = recorded
    try:
        with torch.no_grad():
            model.loss_fn(params, {"tokens": tokens})
    finally:
        moe.moe_route = route
    return min(margins)


def moe_loss_grads(torch, model, params, tokens):
    """One node's loss and its gradient of every leaf (by path)."""
    from repro_torch.core.tree_utils import (tree_flatten_with_path,
                                             tree_unflatten)

    pairs, treedef = tree_flatten_with_path(params)
    leaves = [x.detach().requires_grad_(True) for _, x in pairs]
    loss = model.loss_fn(tree_unflatten(treedef, leaves), {"tokens": tokens})
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), {p: g for (p, _), g in zip(pairs, grads)}


def tp_train_reference(torch, dev, tmp: str) -> dict:
    """32b and 32c unsharded, in this process: 32b's TRAIN_TP steps from
    the seeded init (losses, ms), its final state sampled for each rank's
    shard; 32c's loss and gradients at the first data seed whose router
    margins hold, sampled likewise. The samples are saved to ``tmp``."""
    from repro_torch.launch.sharding import train_state_blocks
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    plan, gamma_n = tp_train_plan(None)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state = plan.init_state(dev, seed=SEED)
    tokens = tp_tokens(torch, dev, tuple(plan.batch_specs["tokens"].shape),
                       plan.model.cfg.vocab_size, SEED + 2)
    losses, ms = [], []
    for t in range(TRAIN_TP["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = plan.step_fn(state, {"tokens": tokens}, SEED + t)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss_mean"]))
    peak = torch.cuda.max_memory_allocated() - base
    named = named_state(torch, state)
    leaves = list(named)
    blocks = []
    for r in range(TP_RANKS):
        b = train_state_blocks(state, plan.model, ModelAxis(size=TP_RANKS,
                                                            rank=r),
                               plan.partition)
        blocks.append({p: ((0, slice(0, TRAIN_TP["n"])),) + blk
                       for p, blk in zip(leaves, b)})
    lm = shard_samples(torch, named, blocks, TP_RANKS)
    del state, named, metrics
    torch.cuda.empty_cache()

    spec, cfg = moe_train_config()
    model = Transformer(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
    shape = (GROUP_TRAIN["per_node_batch"], GROUP_TRAIN["seq_len"])
    for data_seed in range(SEED, SEED + TP_SEED_TRIES):
        tok = tp_tokens(torch, dev, shape, cfg.vocab_size, data_seed)
        margin = router_margins(torch, model, params, tok)
        if margin > TP_ROUTE_MARGIN:
            break
    else:
        raise AssertionError(f"32c: no data seed in {TP_SEED_TRIES} gives "
                             "every top-1 router margin above "
                             f"{TP_ROUTE_MARGIN}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, grads = moe_loss_grads(torch, model, params, tok)
    torch.cuda.synchronize()
    moe_ms = (time.perf_counter() - t0) * 1e3
    shards = [Transformer(cfg, axis=ModelAxis(size=TP_RANKS, rank=r))
              .param_shards() for r in range(TP_RANKS)]
    moe_samples = shard_samples(torch, grads, shards, TP_RANKS)
    del params, grads, model
    torch.cuda.empty_cache()
    paths = []
    for r in range(TP_RANKS):
        path = f"{tmp}/expected{r}.pt"
        torch.save({"lm": lm[r], "moe": moe_samples[r]}, path)
        paths.append(path)
    return dict(paths=paths, gamma_n=gamma_n, losses=losses, step_ms=ms,
                launches=[rank_launches(plan, r) for r in range(TP_RANKS)],
                peak_gb=peak / 1e9, moe_loss=loss, moe_ms=moe_ms,
                moe_data_seed=data_seed, routing_margin=margin,
                d_s=plan.partition.d_shared())


def train_tp_rank(torch, ops, dev, *, rank: int, store: str, out: str,
                  expected: str, gamma_n: float, moe_seed: int) -> None:
    """32b and 32c's rank ``rank`` (``chip_smoke.py --train-rank JSON``): a
    gloo world of TP_RANKS processes on the one card, the (1, TP_RANKS)
    mesh. 32b: the TRAIN_TP plan's two steps from the rank's shard of the
    seeded init (the first under ``CollectiveCount``), its launches and
    peak, its state against the unsharded run's samples; 32c: one node's
    loss and backward of llama4-scout at one MoE layer, the rank's
    gradient shards against the unsharded ones' samples. The results are
    saved to ``out``."""
    import dataclasses
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh, model_axis
    from repro_torch.launch.op_analysis import CollectiveCount
    from repro_torch.models.transformer import Transformer

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=TP_RANKS,
                            timeout=datetime.timedelta(seconds=300))
    try:
        want = torch.load(expected, weights_only=False)
        mesh = make_host_mesh(shape=(1, TP_RANKS))
        plan, _ = tp_train_plan(mesh, gamma_n)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        state = plan.init_state(dev, seed=SEED)
        torch.cuda.synchronize()
        state_gb = (torch.cuda.memory_allocated() - base) / 1e9
        local_gb = sum(x.numel() * x.element_size()
                       for x in state.local) / 1e9
        shared_gb = sum(x.numel() * x.element_size()
                        for x in state.dpps.push.s) / 1e9
        tokens = tp_tokens(torch, dev, tuple(
            plan.batch_specs["tokens"].shape), plan.model.cfg.vocab_size,
            SEED + 2)
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        losses, ms, calls = [], [], []
        for t in range(TRAIN_TP["steps"]):
            count = CollectiveCount() if t == 0 else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if count is not None:
                with count:
                    state, metrics = plan.step_fn(state, {"tokens": tokens},
                                                  SEED + t)
                calls.append({k: count.calls[k] for k in count.calls})
            else:
                state, metrics = plan.step_fn(state, {"tokens": tokens},
                                              SEED + t)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss_mean"]))
        launches = ops.launch_counts()
        mapped = ops.dpps_perturb_rows.mapped_launches
        peak = torch.cuda.max_memory_allocated() - base
        lm = samples_agree(torch, named_state(torch, state), want["lm"])
        del state, metrics
        torch.cuda.empty_cache()

        _, cfg = moe_train_config()
        axis = dataclasses.replace(model_axis(mesh), data_size=1, data_rank=0,
                                   data_group=None)
        model = Transformer(cfg, axis=axis)
        params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
        tok = tp_tokens(torch, dev, (GROUP_TRAIN["per_node_batch"],
                                     GROUP_TRAIN["seq_len"]),
                        cfg.vocab_size, moe_seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        count = CollectiveCount()
        with count:
            moe_loss, grads = moe_loss_grads(torch, model, params, tok)
        torch.cuda.synchronize()
        moe_ms = (time.perf_counter() - t0) * 1e3
        moe = samples_agree(torch, grads, want["moe"])
        moe_calls = {k: count.calls[k] for k in count.calls}
        del params, grads
        torch.cuda.empty_cache()
        torch.save(dict(
            losses=losses, step_ms=ms, calls=calls, launches=launches,
            mapped_launches=mapped, peak_gb=peak / 1e9,
            reckoned_gb=state_gb + 2 * local_gb + shared_gb,
            state_gb=state_gb, lm=lm, moe=moe, moe_loss=moe_loss,
            moe_ms=moe_ms, moe_calls=moe_calls), out)
    finally:
        dist.destroy_process_group()


def strided_perturbation(torch, ops, ref, dev) -> dict:
    """The perturbation at a column map on the card. (a) The main path's
    largest strided leaf: rank 0's half of the columns of llama3.2-1b's
    shared w_up ((4, 2048, 8192) a node, N = 4) at its wire column: s_noise
    bit for bit the whole leaf's launch at those columns and the plain
    version's, its norms within rtol 1e-5; timed beside a contiguous
    launch of the same rows (col0 0), the plain version, the copy and the
    bound. (b) STRIDED_MAPS, bit for bit likewise."""
    from repro_torch.kernels.ref import ColumnMap

    out = {}
    scale = torch.tensor(0.7, device=dev)
    cases = [STRIDED_MAIN] + [(4,) + m for m in STRIDED_MAPS]
    for i, (n, lead, width, a, b, col0) in enumerate(cases):
        size, part = lead * width, lead * (b - a)
        gen = torch.Generator(device=dev).manual_seed(SEED + i)
        s = torch.randn((n, -(-size // 4) * 4), generator=gen, device=dev)
        eps = torch.randn(s.shape, generator=gen, device=dev)
        whole = ops.dpps_perturb_rows(s, eps, scale, 0.1, size, seed=SEED,
                                      t=3, col0=col0, node0=1)[0]

        def cut(x):
            return x[:, :size].reshape(n, lead, width)[..., a:b].reshape(
                n, -1)

        ls, le = ops.leaf_rows(cut(s)), ops.leaf_rows(cut(eps))
        want_noise = cut(whole)
        del s, eps, whole
        cmap = ColumnMap(col0, b - a, width, a)
        got = ops.dpps_perturb_rows(ls, le, scale, 0.1, part, seed=SEED,
                                    t=3, node0=1, col_map=cmap)
        require(torch.equal(got[0][:, :part], want_noise),
                f"strided perturbation {cases[i]}: s_noise is not the whole "
                "launch's columns")
        del want_noise
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ref.dpps_perturb_rows(ls, le, scale, 0.1, part, seed=SEED,
                                      t=3, node0=1, col_map=cmap)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        require(torch.equal(got[0], plain[0]),
                f"strided perturbation {cases[i]}: s_noise is not the plain "
                "version's")
        norm_err = max(((g - p).abs() / p.abs()).max().item()
                       for g, p in zip(got[1:], plain[1:]))
        require(norm_err <= 1e-5, f"strided perturbation {cases[i]}: norms "
                f"{norm_err} from the plain version's")
        entry = dict(n=n, lead=lead, width=width, block=[a, b], col0=col0,
                     run=cmap.run, stride=cmap.stride, off=cmap.off,
                     bit_for_bit=True, norm_rel_err=norm_err,
                     max_abs_err=(got[0] - plain[0]).abs().max().item())
        del plain
        if i == 0:
            d_pad = ls.shape[1]
            entry.update(
                ms=cuda_ms(torch, lambda: ops.dpps_perturb_rows(
                    ls, le, scale, 0.1, part, seed=SEED, t=3,
                    col_map=cmap), 20),
                contiguous_ms=cuda_ms(torch, lambda: ops.dpps_perturb_rows(
                    ls, le, scale, 0.1, part, seed=SEED, t=3), 20),
                plain_ms=plain_ms, library_ms=None,
                copy_ms=copy_ms(torch, ls, le, 20),
                bound=perturb_bound(n, part, d_pad))
            entry["pct_of_bound"] = 100.0 * entry["bound"][0] / entry["ms"]
            entry["vs_contiguous"] = entry["ms"] / entry["contiguous_ms"]
            out["main"] = entry
        else:
            out[f"map{i}"] = entry
        del ls, le, got
        torch.cuda.empty_cache()
    return out


def model_axis_train_phase(torch, ops, ref, dev, smi: str,
                           lm: dict) -> tuple:
    """Phase 32: (a) 29b's TrainPlan on a one-rank NCCL world's (1, 1) mesh,
    bit for bit 29b's after two steps; (b) llama3.2-1b at full width over
    a 2-rank gloo world on the one card (M = 2), N = 4, 2 steps, against
    the unsharded plan on the same weights and bits; (c) llama4-scout at
    one MoE layer, one node's loss and backward at M = 2 against the
    unsharded one; the strided perturbation against its plain version and
    the whole launch. -> (emitted dict, the main paths' launch counts,
    the strided perturbation's entry)."""
    from repro_torch.configs import get_config

    t_start = time.perf_counter()
    out = dict(phase="model_axis_train", card=smi, note=(
        "32b's and 32c's times are two ranks sharing one card's SMs, their "
        "all-reduces gloo's, staged through the host: not speed figures "
        "of tensor parallelism, which wait for a cell of several cards"))
    out["a"], counts = train_one_rank(torch, ops, dev, lm)
    counts = [counts]
    strided = strided_perturbation(torch, ops, ref, dev)
    with tempfile.TemporaryDirectory() as tmp:
        want = tp_train_reference(torch, dev, tmp)
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--train-rank",
             json.dumps(dict(rank=rank, store=f"{tmp}/store",
                             out=f"{tmp}/rank{rank}.pt",
                             expected=want["paths"][rank],
                             gamma_n=want["gamma_n"],
                             moe_seed=want["moe_data_seed"]))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(TP_RANKS)]
        try:
            logs = [p.communicate(timeout=TRAIN_TP_JOIN_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for rank, (p, (_, err)) in enumerate(zip(procs, logs)):
            require(p.returncode == 0,
                    f"32b rank {rank} exited {p.returncode}: {err[-4000:]}")
        ranks = [torch.load(f"{tmp}/rank{rank}.pt", weights_only=False)
                 for rank in range(TP_RANKS)]
    cfg = get_config(TRAIN_TP["arch"]).model
    _, moe_cfg = moe_train_config()
    want_calls = [train_collectives(cfg, TRAIN_TP["n"], TRAIN_TP["seq_len"],
                                    TP_RANKS, 0)]
    want_moe = {"all-reduce": train_pass_collectives(
        moe_cfg, GROUP_TRAIN["seq_len"], TP_RANKS)}
    for rank, r in enumerate(ranks):
        gap = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                       want["losses"]))
        require(gap <= TRAIN_TP_LOSS_RTOL,
                f"32b rank {rank}: losses {r['losses']} against "
                f"{want['losses']}")
        require(r["lm"]["max_abs_err"] <= TRAIN_TP_ATOL,
                f"32b rank {rank}: state {r['lm']}")
        require(r["lm"]["max_norm_rel_gap"] <= TRAIN_TP_NORM_RTOL
                and r["lm"]["vectors_max_rel_err"] <= TRAIN_TP_NORM_RTOL,
                f"32b rank {rank}: leaf norms and vectors {r['lm']}")
        require(r["calls"] == want_calls,
                f"32b rank {rank}: c10d calls {r['calls']}, expected "
                f"{want_calls}")
        launches, mapped = want["launches"][rank]
        require(r["launches"] == launches and r["mapped_launches"] == mapped,
                f"32b rank {rank}: launches {r['launches']}, strided "
                f"{r['mapped_launches']}, expected {launches}, {mapped}")
        require(r["peak_gb"] < want["peak_gb"],
                f"32b rank {rank}: peak {r['peak_gb']} GB not below the "
                f"unsharded {want['peak_gb']} GB")
        require(abs(r["moe_loss"] - want["moe_loss"])
                <= TRAIN_TP_LOSS_RTOL * abs(want["moe_loss"]),
                f"32c rank {rank}: loss {r['moe_loss']} against "
                f"{want['moe_loss']}")
        require(r["moe"]["max_abs_err"] <= TRAIN_TP_ATOL
                and r["moe"]["max_norm_rel_gap"] <= TRAIN_TP_NORM_RTOL,
                f"32c rank {rank}: gradients {r['moe']}")
        require(r["moe_calls"] == want_moe,
                f"32c rank {rank}: c10d calls {r['moe_calls']}, expected "
                f"{want_moe}")
        counts.append(r["launches"])
    out["b"] = dict(unsharded={k: want[k] for k in (
        "losses", "step_ms", "peak_gb", "gamma_n", "d_s")},
        ranks=[{k: r[k] for k in (
            "losses", "step_ms", "calls", "launches", "mapped_launches",
            "peak_gb", "reckoned_gb", "state_gb", "lm")} for r in ranks],
        tolerance=dict(loss_rtol=TRAIN_TP_LOSS_RTOL, atol=TRAIN_TP_ATOL,
                       norm_rtol=TRAIN_TP_NORM_RTOL,
                       sample=TRAIN_TP_SAMPLE), **TRAIN_TP)
    out["c"] = dict(unsharded={k: want[k] for k in (
        "moe_loss", "moe_ms", "moe_data_seed", "routing_margin")},
        ranks=[{k: r[k] for k in ("moe_loss", "moe_ms", "moe", "moe_calls")}
               for r in ranks], route_margin=TP_ROUTE_MARGIN)
    out["strided"] = strided
    out["seconds"] = time.perf_counter() - t_start
    strided["main"]["mapped_launches"] = sum(r["mapped_launches"]
                                              for r in ranks)
    return out, counts, strided


# -- phase 33: the model axis for the recurrent and cross-attention groups -----

# 33a-b's serves at published widths, each with 8 greedy decode steps:
# xlstm-125m whole on a 512-token prompt; zamba2-7b at one of its 11 units
# and no trailing layers, and llama-3.2-vision-11b at one of its 8 units
# (its 1,600 image tokens), on 1,024 tokens. Their prefills are host-bound
# time loops (phase 18), hence the cuts.
GROUPS_SERVE = {
    "xlstm": dict(arch="xlstm-125m", cut=None, prompt=512, steps=8),
    "zamba2": dict(arch="zamba2-7b", cut=dict(n_units=1, trailing_mamba=0),
                   prompt=1024, steps=8),
    "vision": dict(arch="llama-3.2-vision-11b", cut=dict(n_units=1),
                   prompt=1024, steps=8),
}
# 33c: PartPSP of each at M = 2, cut in depth as phase 19 cuts them, on a
# 2-out graph of N = 2 nodes, one 128-token sequence a node (cut from 256
# for the script's time limit with phase 34), 2 steps,
# against the unsharded plan on the same weights and Philox bits. gamma_n
# is GROUPS_NOISE of the Remark-1 stability limit (32b takes half of it):
# at half, the noised mLSTM / Mamba2 / cross layers make the local
# gradients ill-conditioned (xlstm's embedding grew from 0.11 to 1.41 in
# two steps, and a 1e-7 relative change of it alone moved the unsharded
# plan's final embedding by 2.2e-4 at the smoke widths on the CPU, 0.5 at
# full width on the card), so the model axis's 1e-7 sum-order differences
# leave the 32b tolerances; at 1/100 of that the same change moves it
# 1e-7.
GROUPS_TRAIN = dict(n=2, per_node_batch=1, seq_len=128, steps=2)
GROUPS_NOISE = 0.005
GROUPS_TRAIN_RUNS = {
    "xlstm": dict(arch="xlstm-125m", cut=dict(n_units=1)),
    "zamba2": dict(arch="zamba2-7b", cut=dict(n_units=1, trailing_mamba=0)),
    "vision": dict(arch="llama-3.2-vision-11b", cut=dict(n_units=1)),
}
# 33d: the dry run's rows of the three at --model-shards 2 (full size, on
# meta, the card hidden, one process a row), held below phase 29's rows
GROUPS_DRY = tuple((run["arch"], shape) for run in GROUPS_SERVE.values()
                   for shape in ("prefill_32k", "train_4k"))
GROUPS_JOIN_S = 600


def axis_collectives(cfg, b: int, s: int) -> dict:
    """The c10d calls and operand bytes a step of ``b`` sequences of ``s``
    new positions issues on a rank of the model axis (a data dim of 1), as
    ``models/parallel.py``, ``ssm.py`` and ``attention.py`` are written:
    the embedding's sum and the (b, V) logits' gather; an mLSTM layer's
    gather of its (b, s, d_inner) up-projection and its w_down sum; a
    Mamba2 layer's w_out sum; an attention layer's wo and w_down sums
    (zamba's shared block once a unit); a cross layer's wo sum; the sLSTM
    none."""
    act = 4 * b * s * cfg.d_model
    calls, nbytes = 2, act + 4 * b * cfg.vocab_size
    for g in cfg.groups:
        if g.kind in ("attn", "moe"):
            n = 2 * g.n_layers
        elif g.kind == "xlstm":
            n = 2 * g.n_units * g.mlstm_per_unit
            nbytes += (n // 2) * 4 * b * s * int(cfg.d_model * g.proj_factor)
            calls, nbytes = calls + n, nbytes + (n // 2) * act
            continue
        elif g.kind == "mamba":
            n = g.n_layers
        elif g.kind == "zamba":
            n = g.n_units * (g.mamba_per_unit + 2) + g.trailing_mamba
        else:  # cross_self
            n = g.n_units * (1 + 2 * g.self_per_unit)
        calls, nbytes = calls + n, nbytes + n * act
    return {"all-reduce": [calls, nbytes]}


def groups_pass_collectives(cfg, diff: str, seq: int, m: int) -> int:
    """The all-reduces of one node's loss and backward in the PartPSP pass
    that differentiates the ``diff`` ("local" or "shared") leaves of a 33c
    run (under its arch's rules: the mLSTM layers, zamba's shared block
    and the VLM's self layers shared; the embedding local), as the code is
    written: the forward's sums (``axis_collectives``); each
    copy-to-model's gradient sum whose input needs one (an mLSTM's input,
    w_if and b_if; a Mamba2 layer's input and its six whole leaves; an
    attention layer's two; a cross layer's input), the mLSTM gather's;
    the checkpoint recomputation's re-issued sums (an mLSTM's gather, an
    attention layer's first, a unit's inner layers but a cross/self
    unit's last self layer); the loss's embedding sum, a copy-to-model a
    512-position chunk and, at M > 1, its three vocabulary-parallel sums
    and the two its recomputation re-issues."""
    chunks = -(-(seq - 1) // 512)
    calls = 1 + chunks + (5 * chunks if m > 1 else 0)
    local = diff == "local"
    for g in cfg.groups:
        if g.kind == "xlstm":
            calls += g.n_units * g.mlstm_per_unit * (5 if local else 7)
        elif g.kind == "zamba":
            p = g.mamba_per_unit
            if local:
                calls += g.n_units * (9 * p + 5) + 8 * g.trailing_mamba
            else:
                calls += (2 * p + 5) + (g.n_units - 1) * (3 * p + 5) \
                    + 2 * g.trailing_mamba
        elif g.kind == "cross_self":
            p = g.self_per_unit
            calls += g.n_units * (7 * p + 1) - (0 if local else 1)
    return calls


def groups_train_collectives(cfg, part, nodes: int, seq: int, m: int,
                             t: int) -> dict:
    """A rank's round t of a 33c run: both passes of each of its nodes,
    each shared KV head's gradient sum a pass that differentiates it
    (M > K), the per-node norms finished over "model" (the perturbation's,
    the noise's, the clip's; s^(0)'s at round 0)."""
    kv = 0
    if m > cfg.n_kv_heads:
        heads = [a for p, a in part.leaf_plans() if p.endswith(
            ("attn/wk", "attn/wv", "cross/wk", "cross/wv"))]
        kv = sum(a != "shared" for a in heads) + sum(a != "local"
                                                     for a in heads)
    per_node = groups_pass_collectives(cfg, "local", seq, m) + \
        groups_pass_collectives(cfg, "shared", seq, m) + kv
    return {"all-reduce": nodes * per_node + 3 + (t == 0)}


def groups_train_plan(run: dict, mesh, gamma_n: float | None = None):
    """33c's TrainPlan of ``run``: the unsharded one (mesh None) or a
    rank's; gamma_n GROUPS_NOISE of the Remark-1 stability limit of the
    unsharded plan's d_s."""
    import dataclasses

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.steps import build_train_plan

    arch, _ = tp_config(run)
    n = GROUPS_TRAIN["n"]
    shape = ShapeSpec("train_groups", GROUPS_TRAIN["seq_len"],
                      n * GROUPS_TRAIN["per_node_batch"], "train")
    plan = build_train_plan(arch, n if mesh is None else mesh, nodes=n,
                            shape=shape)
    dpps = plan.cfg.dpps
    if gamma_n is None:
        gamma_n = GROUPS_NOISE * (1.0 / dpps.lam - 1.0) * dpps.b / (
            2.0 * dpps.c_prime * plan.partition.d_shared())
    plan.cfg = dataclasses.replace(plan.cfg, dpps=dataclasses.replace(
        dpps, gamma_n=gamma_n))
    return plan, gamma_n


def groups_batch(torch, dev, plan) -> dict:
    """A 33c batch: tokens from SEED + 2, a VLM's image embeddings (normal
    x 0.1) after them."""
    specs = plan.batch_specs
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    batch = {"tokens": torch.randint(
        0, plan.model.cfg.vocab_size, tuple(specs["tokens"].shape),
        generator=gen, device=dev, dtype=torch.int32)}
    if "image_embeds" in specs:
        batch["image_embeds"] = torch.randn(
            tuple(specs["image_embeds"].shape), generator=gen,
            device=dev).mul_(0.1)
    return batch


def groups_launches(plan, rank: int) -> tuple[dict, int]:
    """Rank ``rank``'s exact launches in a 33c run (the tree runtime): a
    norm of each shared leaf whose columns it counts a step (and of s at
    round 0), a perturbation and a mix of each shared leaf a step; and how
    many perturbations draw at strided columns."""
    from repro_torch.launch.sharding import train_columns
    from repro_torch.models.parallel import ModelAxis
    from repro_torch.models.transformer import Transformer

    steps = GROUPS_TRAIN["steps"]
    axis = ModelAxis(size=TP_RANKS, rank=rank)
    counted, maps = train_columns(Transformer(plan.model.cfg, axis=axis),
                                  plan.partition, axis)
    want = {k: 0 for k in KERNELS}
    want.update(l1_norm_rows=sum(counted) * (steps + 1),
                dpps_perturb_rows=len(maps) * steps,
                pushsum_mix=len(maps) * steps)
    return want, sum(not m.contiguous for m in maps) * steps


def groups_train_reference(torch, dev) -> dict:
    """33c unsharded, in this process: each run's steps from the seeded
    init (losses, ms, peak), its final state sampled for each rank's
    shard (``samples[rank]``), each rank's exact launches."""
    from repro_torch.launch.sharding import train_state_blocks
    from repro_torch.models.parallel import ModelAxis

    samples = [{} for _ in range(TP_RANKS)]
    out = {}
    n = GROUPS_TRAIN["n"]
    # in the ranks' reverse order: this process's largest run (the VLM's,
    # 37 GB on an H100 80GB HBM3) runs beside the ranks' smallest
    for name in reversed(GROUPS_TRAIN_RUNS):
        run = GROUPS_TRAIN_RUNS[name]
        plan, gamma_n = groups_train_plan(run, None)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        state = plan.init_state(dev, seed=SEED)
        batch = groups_batch(torch, dev, plan)
        losses, ms = [], []
        for t in range(GROUPS_TRAIN["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = plan.step_fn(state, batch, SEED + t)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(metrics["loss_mean"]))
        peak = torch.cuda.max_memory_allocated() - base
        named = named_state(torch, state)
        leaves = list(named)
        blocks = []
        for r in range(TP_RANKS):
            b = train_state_blocks(state, plan.model,
                                   ModelAxis(size=TP_RANKS, rank=r),
                                   plan.partition)
            blocks.append({p: ((0, slice(0, n)),) + blk
                           for p, blk in zip(leaves, b)})
        for r, got in enumerate(shard_samples(torch, named, blocks,
                                              TP_RANKS)):
            samples[r][name] = got
        out[name] = dict(gamma_n=gamma_n, losses=losses, step_ms=ms,
                         peak_gb=peak / 1e9, d_s=plan.partition.d_shared(),
                         launches=[groups_launches(plan, r)
                                   for r in range(TP_RANKS)],
                         samples=[samples[r].pop(name)
                                  for r in range(TP_RANKS)])
        del state, named, metrics, batch
        torch.cuda.empty_cache()
    return out


def sample_gaps(torch, got: dict, want: dict) -> dict:
    """A rank's :func:`shard_samples` of its own leaves against the
    unsharded run's of the rank's shard: :func:`samples_agree`'s gaps."""
    worst, rel, norm_gap, compared, worst_leaf = 0.0, 0.0, 0.0, 0, None
    require(set(got) == set(want), "the rank's leaves are not the "
            "unsharded run's")
    for path, (k, sample, norm) in got.items():
        k_want, sample_want, norm_want = want[path]
        require(k == k_want and sample.shape == sample_want.shape,
                f"{path}: sampled {k}, {tuple(sample.shape)} against "
                f"{k_want}, {tuple(sample_want.shape)}")
        diff = (sample - sample_want).abs()
        if path.startswith((".dpps/.push/.a", ".dpps/.sens/")):
            rel = max(rel, (diff / sample_want.abs()).max().item())
        elif diff.max().item() > worst:
            worst, worst_leaf = diff.max().item(), path
        norm_gap = max(norm_gap, abs(norm - norm_want) / max(norm_want,
                                                            1e-30))
        compared += sample.numel()
    return dict(max_abs_err=worst, worst_leaf=worst_leaf,
                vectors_max_rel_err=rel, max_norm_rel_gap=norm_gap,
                compared=compared, leaves=len(got))


def groups_rank(torch, ops, ref, dev, *, rank: int, store: str, out: str,
                seeds: str) -> None:
    """33b and 33c's rank ``rank`` (``chip_smoke.py --groups-rank JSON``): a
    gloo world of TP_RANKS processes on the one card, the (1, TP_RANKS)
    mesh, beside the parent's 33a and unsharded 33c. 33c first: each of
    GROUPS_TRAIN_RUNS, its steps from the rank's shard of the seeded init
    (the first under ``C10dCount``), its launches and peak, and its final
    state sampled as the parent samples the rank's shard of the unsharded
    one (:func:`shard_samples`); then 33b, once the parent has written the
    data seeds of its unsharded serves to ``seeds``: each of GROUPS_SERVE
    through ``tp_serve`` and, where it attends, the flash launch at its
    head shard. Saved to ``out``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=TP_RANKS,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_host_mesh(shape=(1, TP_RANKS))
        trained = {}
        for name, run in GROUPS_TRAIN_RUNS.items():
            # gamma_n from the unsharded plan's d_s (on meta)
            plan, _ = groups_train_plan(run, mesh,
                                        groups_train_plan(run, None)[1])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            state = plan.init_state(dev, seed=SEED)
            batch = groups_batch(torch, dev, plan)
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            losses, ms, calls = [], [], []
            for t in range(GROUPS_TRAIN["steps"]):
                count = C10dCount() if t == 0 else None
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if count is not None:
                    with count:
                        state, metrics = plan.step_fn(state, batch, SEED + t)
                    calls.append(dict(count.calls))
                else:
                    state, metrics = plan.step_fn(state, batch, SEED + t)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(metrics["loss_mean"]))
            trained[name] = dict(
                losses=losses, step_ms=ms, calls=calls,
                launches=ops.launch_counts(),
                mapped_launches=ops.dpps_perturb_rows.mapped_launches,
                peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
            named = named_state(torch, state)
            trained[name]["samples"] = shard_samples(
                torch, named, [dict.fromkeys(named)], 1)[0]
            del state, metrics, batch, named
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        while not os.path.exists(seeds):
            if time.perf_counter() - t0 > GROUPS_JOIN_S:
                raise TimeoutError(f"33b: no data seeds in {seeds}")
            time.sleep(0.2)
        data_seeds = json.loads(Path(seeds).read_text())
        waited_s = time.perf_counter() - t0
        served = {}
        for name, run in GROUPS_SERVE.items():
            served[name] = tp_serve(torch, ops, dev, run, mesh,
                                    data_seeds[name])
            _, cfg = tp_config(run)
            if attention_layers(cfg):
                served[name]["flash_check"] = tp_flash_check(
                    torch, ops, ref, dev, cfg, run["prompt"], TP_RANKS, rank)
            torch.cuda.empty_cache()
        torch.save(dict(served=served, trained=trained,
                        waited_for_seeds_s=waited_s), out)
    finally:
        dist.destroy_process_group()


def groups_dryrun_start(tmp: str) -> dict:
    """33d: ``python -m repro_torch.launch.dryrun --arch A --shape S
    --model-shards 2 --nodes 16`` for each of GROUPS_DRY, all at once, on
    meta with the card hidden, niced -> {(arch, shape): Popen}."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    return {(arch, shape): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--nodes", str(DRYRUN_NODES), "--model-shards",
         str(TP_RANKS), "--out", f"{tmp}/{arch}_{shape}.json"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        preexec_fn=niced)
        for arch, shape in GROUPS_DRY}


def niced() -> None:
    """A child process's lower priority (os.nice acts on it alone): the
    dry runs' meta traces yield the host to the phases they run beside."""
    os.nice(10)


def dry_runs_start() -> tuple:
    """Phase 29a's, 33d's and 34d's dry runs, started before phase 24:
    CPU-only processes that trace beside phases 24-28 instead of holding
    up phase 29 (each phase reads its rows when it comes). Stopped, and
    their directory removed, at exit whatever happens. -> (29a's
    processes, 33d's, 34d's, their directory, the start time)."""
    import atexit
    import shutil

    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun")
    procs, groups = dryrun_start(tmp), groups_dryrun_start(tmp)
    rest = rest_dryrun_start(tmp)

    def stop():
        for proc in [*procs.values(), *groups.values(), *rest.values()]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return procs, groups, rest, tmp, time.perf_counter()


def groups_dryrun_finish(procs: dict, tmp: str, dry_rows: list) -> list:
    """33d's rows: each ``ok``, its FLOPs a chip and peak below phase 29's
    unsharded row of the same (arch, shape), its collectives counted."""
    whole = {(r["arch"], r["shape"]): r for r in dry_rows}
    rows = []
    for (arch, shape), proc in procs.items():
        out, _ = proc.communicate(timeout=GROUPS_JOIN_S)
        require(proc.returncode == 0, f"33d: dry run of {arch} x {shape} "
                f"exited {proc.returncode}: {out[-3000:]}")
        (row,) = json.loads(Path(f"{tmp}/{arch}_{shape}.json").read_text())
        w = whole[(arch, shape)]
        require(row["status"] == "ok" == w["status"],
                f"33d: {arch} x {shape} at M = {TP_RANKS}: {row}")
        require(row["flops_per_chip"] < w["flops_per_chip"]
                and row["peak_bytes"] < w["peak_bytes"],
                f"33d: {arch} x {shape}: a rank's FLOPs / peak "
                f"{row['flops_per_chip']} / {row['peak_bytes']} not below "
                f"the whole {w['flops_per_chip']} / {w['peak_bytes']}")
        require(row["coll_calls"].get("all-reduce", 0) > 0,
                f"33d: {arch} x {shape}: no collective counted")
        rows.append(dict(arch=arch, shape=shape, mesh=row["mesh"], **{
            k: row[k] for k in ("flops_per_chip", "peak_bytes", "fits",
                                "coll_calls", "trace_s")},
            whole_flops_per_chip=w["flops_per_chip"],
            whole_peak_bytes=w["peak_bytes"]))
    return rows


def model_axis_groups_phase(torch, ops, ref, dev, smi: str, dry_rows: list,
                            dry: tuple) -> tuple:
    """Phase 33: the model axis for the xLSTM, Mamba2/Zamba2 and
    cross-attention groups. (a) GROUPS_SERVE through ``build_serve_plan(
    arch, mesh)`` on a one-rank NCCL world's (1, 1) mesh, bit for bit the
    unsharded plan; (b) the same over a 2-rank gloo world on the one card
    (M = 2) against the unsharded plan, with ``flash_attention.cu`` at
    each rank's head shard; (c) GROUPS_TRAIN_RUNS trained at M = 2 on the
    same ranks against the unsharded plan; (d) the dry run's rows at
    --model-shards 2 below phase 29's (``dry``: their processes and
    directory, started with phase 29's). The ranks train (c) while this
    process runs (a) and (c) unsharded, then serve (b) on (a)'s data
    seeds. -> (emitted dict, the main paths' launch counts, each rank's
    flash checks, the strided perturbations of 33c)."""
    import torch.distributed as dist

    t_start = time.perf_counter()
    out = dict(phase="model_axis_groups", card=smi, note=(
        "33b's and 33c's times are two ranks sharing one card's SMs, their "
        "all-reduces gloo's, staged through the host: not speed figures "
        "of tensor parallelism, which wait for a cell of several cards"))
    counts = []
    with tempfile.TemporaryDirectory() as tmp:
        # the ranks' output to files: this process reads no pipe meanwhile
        seeds_path = f"{tmp}/seeds.json"
        logs = [open(f"{tmp}/rank{rank}.log", "w+")
                for rank in range(TP_RANKS)]
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--groups-rank",
             json.dumps(dict(rank=rank, store=f"{tmp}/store",
                             out=f"{tmp}/rank{rank}.pt", seeds=seeds_path))],
            stdout=log, stderr=subprocess.STDOUT, text=True)
            for rank, log in enumerate(logs)]
        try:
            refs = {name: tp_reference(torch, ops, dev, run)
                    for name, run in GROUPS_SERVE.items()}
            Path(seeds_path + ".part").write_text(json.dumps(
                {name: r["data_seed"] for name, r in refs.items()}))
            os.replace(seeds_path + ".part", seeds_path)
            with tempfile.TemporaryDirectory() as one_tmp:
                mesh = shard_world(one_tmp)
                try:
                    ones = {name: tp_serve(torch, ops, dev, run, mesh,
                                           refs[name]["data_seed"])
                            for name, run in GROUPS_SERVE.items()}
                finally:
                    dist.destroy_process_group()
            torch.cuda.empty_cache()
            want_train = groups_train_reference(torch, dev)
            for p in procs:
                p.wait(timeout=GROUPS_JOIN_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = []
        for rank, (p, log) in enumerate(zip(procs, logs)):
            log.seek(0)
            if p.returncode != 0:
                bad.append(f"rank {rank} exited {p.returncode}: "
                           f"{log.read()[-4000:]}")
            log.close()
        require(not bad, "33b-c " + "\n".join(bad))
        ranks = [torch.load(f"{tmp}/rank{rank}.pt", weights_only=False)
                 for rank in range(TP_RANKS)]
    dry_t0 = time.perf_counter()
    out["d"] = dict(rows=groups_dryrun_finish(*dry, dry_rows),
                    wait_s=time.perf_counter() - dry_t0)

    out["a"] = {}
    for name, run in GROUPS_SERVE.items():
        one, want = ones[name], refs[name]
        _, cfg = tp_config(run)
        require(torch.equal(one["logits"], want["logits"]),
                f"33a {name}: the one-rank model axis is not the unsharded "
                "plan bit for bit")
        calls = [axis_collectives(cfg, 1, run["prompt"])] + \
            [axis_collectives(cfg, 1, 1)] * TP_WARMUP_STEPS
        require(one["calls"] == calls, f"33a {name}: c10d calls "
                f"{one['calls'][:2]}, expected {calls[:2]}")
        require(one["launches"]["flash_attention"] == attention_layers(cfg),
                f"33a {name}: flash launches {one['launches']}")
        counts.append(one["launches"])
        out["a"][name] = dict(tp_summary(one), bit_for_bit=True,
                              unsharded=tp_summary(want))

    out["b"], flash_checks = {}, []
    for name, run in GROUPS_SERVE.items():
        want = refs[name]
        _, cfg = tp_config(run)
        calls = [axis_collectives(cfg, 1, run["prompt"])] + \
            [axis_collectives(cfg, 1, 1)] * TP_WARMUP_STEPS
        for rank, r in enumerate(ranks):
            got = r["served"][name]
            require(torch.equal(got["logits"],
                                ranks[0]["served"][name]["logits"]),
                    f"33b {name}: rank {rank}'s logits differ from rank 0's")
            err = (got["logits"] - want["logits"]).abs().max().item()
            require(err <= TP_ATOL,
                    f"33b {name}: rank {rank} logits max abs err {err}")
            require(torch.equal(got["tokens"], want["tokens"]),
                    f"33b {name}: rank {rank}'s greedy tokens differ")
            require(got["calls"] == calls,
                    f"33b {name}: rank {rank} c10d calls "
                    f"{got['calls'][:2]}, expected {calls[:2]}")
            require(got["launches"]["flash_attention"]
                    == attention_layers(cfg),
                    f"33b {name}: rank {rank} flash launches "
                    f"{got['launches']}")
            require(got["peak_gb"] < want["peak_gb"],
                    f"33b {name}: rank {rank}'s peak {got['peak_gb']} GB is "
                    f"not below the unsharded {want['peak_gb']} GB")
            counts.append(got["launches"])
            got["max_abs_err"] = err
            if "flash_check" in got:
                flash_checks.append(dict(
                    got["flash_check"], rank=rank, run=name,
                    launches=got["launches"]["flash_attention"]))
        out["b"][name] = dict(
            unsharded=tp_summary(want),
            ranks=[tp_summary(r["served"][name]) for r in ranks],
            ranks_bit_equal=True,
            tolerance=dict(atol=TP_ATOL, logit_margin=TP_LOGIT_MARGIN))

    out["c"], strided = {}, dict(launches=0, by_run={})
    seq, nodes = GROUPS_TRAIN["seq_len"], GROUPS_TRAIN["n"]
    for name, run in GROUPS_TRAIN_RUNS.items():
        want = want_train[name]
        plan, _ = groups_train_plan(run, None, want["gamma_n"])
        want_calls = [groups_train_collectives(
            plan.model.cfg, plan.partition, nodes, seq, TP_RANKS, 0)]
        for rank, r in enumerate(ranks):
            got = r["trained"][name]
            gap = max(abs(a - b) / abs(b)
                      for a, b in zip(got["losses"], want["losses"]))
            require(gap <= TRAIN_TP_LOSS_RTOL,
                    f"33c {name} rank {rank}: losses {got['losses']} "
                    f"against {want['losses']}")
            st = got["state"] = sample_gaps(torch, got.pop("samples"),
                                            want["samples"][rank])
            require(st["max_abs_err"] <= TRAIN_TP_ATOL,
                    f"33c {name} rank {rank}: state {st}")
            require(st["max_norm_rel_gap"] <= TRAIN_TP_NORM_RTOL
                    and st["vectors_max_rel_err"] <= TRAIN_TP_NORM_RTOL,
                    f"33c {name} rank {rank}: leaf norms and vectors {st}")
            require(got["calls"] == want_calls,
                    f"33c {name} rank {rank}: c10d calls {got['calls']}, "
                    f"expected {want_calls}")
            launches, mapped = want["launches"][rank]
            require(got["launches"] == launches
                    and got["mapped_launches"] == mapped,
                    f"33c {name} rank {rank}: launches {got['launches']}, "
                    f"strided {got['mapped_launches']}, expected "
                    f"{launches}, {mapped}")
            require(got["peak_gb"] < want["peak_gb"],
                    f"33c {name} rank {rank}: peak {got['peak_gb']} GB not "
                    f"below the unsharded {want['peak_gb']} GB")
            counts.append(got["launches"])
            strided["launches"] += got["mapped_launches"]
            strided["by_run"][name] = strided["by_run"].get(
                name, 0) + got["mapped_launches"]
        out["c"][name] = dict(
            unsharded={k: want[k] for k in ("losses", "step_ms", "peak_gb",
                                            "gamma_n", "d_s")},
            ranks=[r["trained"][name] for r in ranks],
            calls_first_step=want_calls, **run)
    out["c"]["ranks_waited_for_seeds_s"] = [r["waited_for_seeds_s"]
                                            for r in ranks]
    require(strided["by_run"].get("xlstm", 0) > 0,
            "33c: xlstm's strided perturbations were not launched")
    out["c"]["tolerance"] = dict(loss_rtol=TRAIN_TP_LOSS_RTOL,
                                 atol=TRAIN_TP_ATOL,
                                 norm_rtol=TRAIN_TP_NORM_RTOL,
                                 sample=TRAIN_TP_SAMPLE, **GROUPS_TRAIN)
    out["seconds"] = time.perf_counter() - t_start
    return out, counts, flash_checks, strided


# -- phase 34: the rest of the model axis ------------------------------------

# 34a-b: gemma3-1b at full width (H = 4, K = 1, D = 256, 26 layers) served
# through build_serve_plan(arch, mesh): a 512-token prompt and 2 greedy
# decode steps. 34b over REST_RANKS gloo ranks on the card, mesh (1, 8):
# ranks 1, 3, 5 and 7 hold one query head each (and the one KV head), the
# other four none (an M that does not divide H).
REST_SERVE = dict(arch="gemma3-1b", layers=None, prompt=512, steps=2)
REST_RANKS = 8
# 34c: long_500k decode (global batch 1, 524,288 slots) over
# REST_SEQ_RANKS gloo ranks at (2, 1): each KV cache's slots split over
# "data" (gemma3-1b whole: 26 x 524,288 x 256 x 4 B x 2 = 27.9 GB, 14 GB a
# rank; zamba2-7b at one unit: its shared block's 15.0 GB), REST_LONG_STEPS
# greedy steps at positions 524,284-524,287 from a seeded cache: each KV
# leaf drawn in REST_FILL_BLOCKS blocks of slots, block b of leaf i from
# its own generator, so a rank draws its blocks alone and the whole cache
# is the blocks together (no 524k prefill).
REST_LONG = {"gemma3-1b": None, "zamba2-7b": dict(n_units=1)}
REST_LONG_STEPS = 4
REST_SEQ_RANKS = 2
REST_FILL_BLOCKS = 8
# 34d: the dry run's rows on the reference's production mesh (data 16,
# model 16), started with 29a's and 33d's
REST_DRY = (("llama4-scout-17b-a16e", "prefill_32k"),
            ("gemma3-1b", "long_500k"), ("zamba2-7b", "long_500k"))
REST_JOIN_S = 600


def rest_long_config(arch: str):
    """(ArchSpec, ModelConfig) of a 34c run: the published width, zamba2's
    group cut to one unit (its trailing Mamba2 layers kept)."""
    return tp_config(dict(arch=arch, cut=REST_LONG[arch]))


def rest_long_cache(torch, model, dev) -> dict:
    """``model``'s long_500k cache on this rank (its slots where they are
    split over "data"), filled from the seeded draw: each KV leaf's slots
    in REST_FILL_BLOCKS blocks, block b of leaf i normal x 0.5 from a
    generator seeded by (i, b), the rank drawing its own blocks; each
    recurrent state whole, normal x 0.1 from a generator seeded by its
    leaf."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.core.tree_utils import tree_flatten_with_path

    t = INPUT_SHAPES["long_500k"].seq_len
    axis = model.axis
    cache = model.init_cache(1, t, device=dev)
    for i, (path, x) in enumerate(tree_flatten_with_path(cache)[0]):
        gen = torch.Generator(device=dev)
        if not path.endswith(("/k", "/v")):
            gen.manual_seed(SEED * 1000 + i)
            x.copy_(torch.randn(x.shape, generator=gen, device=dev) * 0.1)
            continue
        local = x.shape[-3]
        whole = local * (axis.data_size if axis.seq_split else 1)
        per = whole // REST_FILL_BLOCKS
        first = (axis.data_rank * local if axis.seq_split else 0) // per
        for j in range(local // per):
            gen.manual_seed((SEED * 1000 + i) * REST_FILL_BLOCKS + first + j)
            blk = x.narrow(-3, j * per, per)
            blk.copy_(torch.randn(blk.shape, generator=gen, device=dev)
                      * 0.5)
    return cache


def rest_long(torch, ops, dev, arch: str, mesh, tokens=None) -> dict:
    """REST_LONG_STEPS greedy long_500k decode steps of ``arch`` through
    ``build_serve_plan(arch, mesh, shape_name="long_500k")`` (None: the
    unsharded plan) from :func:`rest_long_cache`, the weights the model's
    draw from SEED, the first token seeded; ``tokens`` (the unsharded
    run's) teacher-forces the steps after the first. The launch counts are
    set to 0 before the steps and read after. -> CPU logits, tokens, the
    top-1 margins, ms a step, c10d calls a step, launches, peak, the cache
    on the rank."""
    from repro_torch.configs import INPUT_SHAPES
    from repro_torch.core.tree_utils import tree_leaves
    from repro_torch.launch.steps import build_serve_plan

    spec, cfg = rest_long_config(arch)
    plan = build_serve_plan(spec, mesh, shape_name="long_500k")
    t = INPUT_SHAPES["long_500k"].seq_len
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = plan.model.init(torch.Generator(device=dev).manual_seed(SEED),
                             dev)
    t0 = time.perf_counter()
    cache = rest_long_cache(torch, plan.model, dev)
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    cache_gb = sum(x.numel() * x.element_size()
                   for x in tree_leaves(cache)) / 1e9
    gen = torch.Generator(device=dev).manual_seed(SEED + 34)
    tok = torch.randint(0, cfg.vocab_size, (1,), generator=gen, device=dev)
    logits, calls, times = [], [], []
    ops.reset_launch_counts()
    for i in range(REST_LONG_STEPS):
        count = C10dCount()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with count:
            lg, cache = plan.step_fn(params, cache, tok,
                                     t - REST_LONG_STEPS + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        calls.append(dict(count.calls))
        logits.append(lg.float())
        tok = lg.argmax(dim=-1) if tokens is None else \
            tokens[i].to(dev).reshape(1)
    launches = ops.launch_counts()
    stacked = torch.cat(logits)
    top2 = stacked.topk(2, dim=-1).values
    out = dict(logits=stacked.cpu(), tokens=stacked.argmax(dim=-1).cpu(),
               margins=(top2[:, 0] - top2[:, 1]).cpu(), ms_per_step=times,
               calls=calls, launches=launches, fill_s=fill_s,
               cache_gb=cache_gb, peak_gb=torch.cuda.max_memory_allocated()
               / 1e9, seq_split=plan.model.axis.seq_split,
               slots=t // (plan.model.axis.data_size
                           if plan.model.axis.seq_split else 1))
    del cache, params
    torch.cuda.empty_cache()
    return out


def rest_long_calls(cfg, data: int) -> int:
    """The c10d calls of a long_500k decode step on a rank of a (data, 1)
    mesh: the embedding's and the logits' sums and each attention layer's
    ``wo`` and MLP sums over "model" (a group of one rank issues them),
    each Mamba2 layer's ``w_out`` sum, and with a data dim above 1 each
    attention application's MAX and SUM over "data"."""
    merge = 2 if data > 1 else 0
    calls = 2
    for g in cfg.groups:
        if g.kind == "attn":
            calls += (2 + merge) * g.n_layers
        elif g.kind == "zamba":
            calls += g.n_units * (g.mamba_per_unit + 2 + merge) \
                + g.trailing_mamba
    return calls


def rest_summary(r: dict) -> dict:
    return {k: v for k, v in r.items()
            if k not in ("logits", "tokens", "margins")}


def rest_rank(torch, ops, ref, dev, *, rank: int, store: str, out: str,
              kind: str, world: int, data_seed: int | None = None,
              tokens: dict | None = None) -> None:
    """One rank of 34b (``kind`` "serve": gemma3-1b over the (1, world)
    mesh, ``tp_serve`` and the flash launch at its head share) or 34c
    (``kind`` "long": each of REST_LONG over the (world, 1) mesh, teacher
    -forced by the unsharded run's ``tokens``), a gloo world on the one
    card (``chip_smoke.py --rest-rank JSON``); the results saved to
    ``out``."""
    import datetime

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        if kind == "serve":
            mesh = make_host_mesh(shape=(1, world))
            r = tp_serve(torch, ops, dev, REST_SERVE, mesh, data_seed)
            r["flash_check"] = tp_flash_check(
                torch, ops, ref, dev, tp_config(REST_SERVE)[1],
                REST_SERVE["prompt"], world, rank)
        else:
            mesh = make_host_mesh(shape=(world, 1))
            r = {arch: rest_long(torch, ops, dev, arch, mesh,
                                 torch.tensor(tokens[arch]))
                 for arch in REST_LONG}
        torch.save(r, out)
    finally:
        dist.destroy_process_group()


def rest_ranks(torch, tmp: str, world: int, **kw) -> list:
    """``world`` ``chip_smoke.py --rest-rank JSON`` processes on the card,
    their output to files (two ranks on pipes no one read died once) ->
    each rank's saved results."""
    procs, logs = [], []
    for rank in range(world):
        log = open(f"{tmp}/rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rest-rank",
             json.dumps(dict(kw, rank=rank, store=f"{tmp}/store",
                             out=f"{tmp}/rank{rank}.pt", world=world))],
            stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=REST_JOIN_S)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, p in enumerate(procs):
        log = Path(f"{tmp}/rank{rank}.log").read_text()
        require(p.returncode == 0, f"34 {kw['kind']} rank {rank} exited "
                f"{p.returncode}: {log[-4000:]}")
    out = [torch.load(f"{tmp}/rank{rank}.pt", weights_only=False)
           for rank in range(world)]
    for rank in range(world):
        os.remove(f"{tmp}/rank{rank}.pt")
    return out


def rest_dryrun_start(tmp: str) -> dict:
    """34d: ``python -m repro_torch.launch.dryrun --arch A --shape S --mesh
    pod16x16`` for each of REST_DRY, all at once, on meta with the card
    hidden, niced -> {(arch, shape): Popen}."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    return {(arch, shape): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "pod16x16", "--out",
         f"{tmp}/pod_{arch}_{shape}.json"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        preexec_fn=niced)
        for arch, shape in REST_DRY}


def rest_dryrun_finish(procs: dict, tmp: str) -> list:
    """34d's rows: each ``ok`` on pod16x16, its busiest model rank named,
    its collectives counted (a long_500k row's KV slots split over
    "data")."""
    rows = []
    for (arch, shape), proc in procs.items():
        out, _ = proc.communicate(timeout=REST_JOIN_S)
        require(proc.returncode == 0, f"34d: dry run of {arch} x {shape} "
                f"exited {proc.returncode}: {out[-3000:]}")
        (row,) = json.loads(
            Path(f"{tmp}/pod_{arch}_{shape}.json").read_text())
        require(row["status"] == "ok" and row["mesh"] == "pod16x16",
                f"34d: {arch} x {shape} on pod16x16: {row}")
        require(row["coll_calls"].get("all-reduce", 0) > 0
                and row["seq_sharded"] == (shape == "long_500k"),
                f"34d: {arch} x {shape}: {row}")
        rows.append({k: row[k] for k in (
            "arch", "shape", "mesh", "model_rank", "heads", "kv_heads",
            "flops_per_chip", "peak_bytes", "fits", "coll_calls",
            "seq_sharded", "trace_s")})
    return rows


def rest_axis_phase(torch, ops, ref, dev, smi: str, dry: tuple) -> tuple:
    """Phase 34: (a) a one-rank NCCL world's (1, 1) mesh with both of this
    phase's features on (the head shares, the long_500k plans' shard_seq):
    gemma3-1b's serve and both long_500k decodes bit for bit the
    unsharded plan; (b) gemma3-1b over REST_RANKS gloo ranks at (1, 8),
    four ranks without heads; (c) the long_500k decodes over
    REST_SEQ_RANKS gloo ranks at (2, 1), each KV cache's slots split;
    (d) the production-mesh dry-run rows. -> (emitted dict, the main paths'
    launch counts, the flash checks at each rank's head share)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    out = dict(phase="model_axis_rest", card=smi, note=(
        "34b-c's times are ranks sharing one card's SMs, their "
        "all-reduces gloo's, staged through the host: not speed figures "
        "of tensor or sequence parallelism"))
    counts, flash_checks = [], []
    _, cfg = tp_config(REST_SERVE)
    want = tp_reference(torch, ops, dev, REST_SERVE)
    longs = {arch: rest_long(torch, ops, dev, arch, None)
             for arch in REST_LONG}
    for arch, r in longs.items():
        require(bool(torch.isfinite(r["logits"]).all()),
                f"34: {arch} long_500k logits")

    # (a) one NCCL rank
    with tempfile.TemporaryDirectory() as tmp:
        mesh = shard_world(tmp)
        try:
            one = tp_serve(torch, ops, dev, REST_SERVE, mesh,
                           want["data_seed"])
            one_long = {"gemma3-1b": rest_long(torch, ops, dev,
                                               "gemma3-1b", mesh)}
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    require(torch.equal(one["logits"], want["logits"]),
            "34a: gemma3-1b over a one-rank mesh is not the unsharded plan "
            "bit for bit")
    require(one["launches"]["flash_attention"] == cfg.total_layers,
            f"34a: flash launches {one['launches']}")
    counts.append(one["launches"])
    for arch, r in one_long.items():
        require(torch.equal(r["logits"], longs[arch]["logits"]),
                f"34a: {arch}'s long_500k decode over a one-rank mesh is not "
                "the unsharded plan bit for bit")
        _, lcfg = rest_long_config(arch)
        require(r["calls"] == [{"all-reduce": rest_long_calls(lcfg, 1)}]
                * REST_LONG_STEPS, f"34a: {arch} c10d calls {r['calls']}")
    out["a"] = dict(serve=tp_summary(one), unsharded=tp_summary(want),
                    long={a: rest_summary(r) for a, r in one_long.items()},
                    bit_for_bit=True)

    # (b) eight gloo ranks at (1, 8): four hold no heads
    with tempfile.TemporaryDirectory() as tmp:
        ranks = rest_ranks(torch, tmp, REST_RANKS, kind="serve",
                           data_seed=want["data_seed"])
    calls = [tp_collectives(cfg, 1, REST_SERVE["prompt"])] + \
        [tp_collectives(cfg, 1, 1)] * TP_WARMUP_STEPS
    from repro_torch.models.parallel import ModelAxis

    for rank, got in enumerate(ranks):
        share = ModelAxis(size=REST_RANKS, rank=rank).attn_heads(
            cfg.n_heads, cfg.n_kv_heads)
        require(torch.equal(got["logits"], ranks[0]["logits"]),
                f"34b: rank {rank}'s logits differ from rank 0's")
        err = (got["logits"] - want["logits"]).abs().max().item()
        require(err <= TP_ATOL, f"34b: rank {rank} logits max abs err {err}")
        require(torch.equal(got["tokens"], want["tokens"]),
                f"34b: rank {rank}'s greedy tokens differ")
        require(got["calls"] == calls, f"34b: rank {rank} c10d calls "
                f"{got['calls'][:2]}, expected {calls[:2]}")
        require(got["launches"]["flash_attention"] == (
            cfg.total_layers if share.h else 0),
            f"34b: rank {rank} ({share}) flash launches {got['launches']}")
        got["max_abs_err"], got["heads"] = err, (share.h, share.kv)
        counts.append(got["launches"])
        flash_checks.append(dict(got["flash_check"], rank=rank,
                                 run="gemma3-1b_m8",
                                 launches=got["launches"]["flash_attention"]))
    out["b"] = dict(unsharded=tp_summary(want), ranks_bit_equal=True,
                    ranks=[dict(tp_summary(r), heads=r["heads"])
                           for r in ranks],
                    tolerance=dict(atol=TP_ATOL,
                                   logit_margin=TP_LOGIT_MARGIN))

    # (c) the long_500k decodes over two data ranks, slots split
    with tempfile.TemporaryDirectory() as tmp:
        ranks = rest_ranks(torch, tmp, REST_SEQ_RANKS, kind="long",
                           tokens={a: r["tokens"].tolist()
                                   for a, r in longs.items()})
    out["c"] = {}
    for arch, w in longs.items():
        _, lcfg = rest_long_config(arch)
        for rank, r in enumerate(ranks):
            got = r[arch]
            require(got["seq_split"], f"34c: {arch} rank {rank} not split")
            require(torch.equal(got["logits"], ranks[0][arch]["logits"]),
                    f"34c: {arch}: rank {rank}'s logits differ from rank 0's")
            err = (got["logits"] - w["logits"]).abs().max().item()
            require(err <= TP_ATOL,
                    f"34c: {arch} rank {rank} logits max abs err {err}")
            sure = w["margins"] > TP_LOGIT_MARGIN
            require(bool((got["tokens"] == w["tokens"])[sure].all()),
                    f"34c: {arch} rank {rank}'s greedy tokens differ where "
                    f"the margin is above {TP_LOGIT_MARGIN}")
            require(got["calls"] == [{"all-reduce": rest_long_calls(
                lcfg, REST_SEQ_RANKS)}] * REST_LONG_STEPS,
                f"34c: {arch} rank {rank} c10d calls {got['calls']}")
            require(got["peak_gb"] < w["peak_gb"],
                    f"34c: {arch} rank {rank}'s peak {got['peak_gb']} GB not "
                    f"below the unsharded {w['peak_gb']}")
            got["max_abs_err"] = err
        out["c"][arch] = dict(
            unsharded=rest_summary(w),
            min_margin=w["margins"].min().item(),
            tokens_equal=all(torch.equal(r[arch]["tokens"], w["tokens"])
                             for r in ranks),
            ranks=[rest_summary(r[arch]) for r in ranks],
            ranks_bit_equal=True, tolerance=dict(atol=TP_ATOL))

    # (d) the production mesh's dry-run rows
    out["d"] = rest_dryrun_finish(*dry)
    out["seconds"] = time.perf_counter() - t0
    return out, counts, flash_checks



def sparse_graph(n: int, seed: int = 0):
    from repro_torch.net import ErdosRenyiGraph

    return ErdosRenyiGraph(n, p=8.0 / n, seed=seed)


# -- phase 35: the examples on the port -----------------------------------------

EXAMPLES_DIR = ROOT / "examples_torch"
PROTOCOL_KERNELS = ("l1_norm_rows", "dpps_perturb_rows")
# (script, arguments, the kernels its path must launch): the circulant
# schedules (d-Out graphs) mix by rolls, which have no kernel; the dense
# ones launch pushsum_mix. partpsp_train runs llama3.2-1b at full width,
# one step a segment (so its second step is timed alone).
EXAMPLE_RUNS = (
    ("quickstart", [], PROTOCOL_KERNELS),
    ("partpsp_train", ["--full-scale", "--nodes", "4", "--steps", "2",
                       "--chunk", "1"], PROTOCOL_KERNELS),
    ("decentralized_serve", [], DENSE_PATH),
    ("fault_tolerance", [], DENSE_PATH),
    ("observability", ["--events", "{tmp}/events.jsonl"], PROTOCOL_KERNELS),
    ("privacy_sweep", ["--smoke"], PROTOCOL_KERNELS),
)
# attention_train at llama3.2-1b's width: (B, S, d_model, H, K, D, theta)
EXAMPLE_ATTN = (1, 2048, 2048, 32, 8, 64, 500000.0)


def load_example(name: str):
    """``examples_torch/<name>.py`` as a module, its directory on
    ``sys.path`` (privacy_sweep imports ``paper_setup`` beside it)."""
    import importlib.util

    if str(EXAMPLES_DIR) not in sys.path:
        sys.path.insert(0, str(EXAMPLES_DIR))
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES_DIR / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def example_checks(name: str, out) -> dict:
    """Each example's own outcome, beyond its launches."""
    import numpy as np

    if name == "quickstart":
        require(math.isfinite(out["error"]), "quickstart: consensus error")
        return dict(error=out["error"], epsilon=out["report"].epsilon_spent)
    if name == "partpsp_train":
        rep = out["report"]
        loss = np.asarray(rep.trajectory["loss_mean"])
        require(loss.shape == (2,) and np.isfinite(loss).all(),
                f"partpsp_train: loss {loss}")
        require(out["summary"]["rounds"] == 2, "partpsp_train: summary")
        # the second step alone (one step a segment; the first carries the
        # kernels' load)
        return dict(d_shared=out["d_shared"], d_local=out["d_local"],
                    loss=loss.tolist(), first_step_s=rep.compile_s,
                    step_ms=rep.run_s * 1e3, summary=out["summary"])
    if name == "decentralized_serve":
        toks = out["serve"].tokens.cpu()
        require(tuple(toks.shape) == (2, 12) and bool(
            ((toks >= 0) & (toks < out["vocab_size"])).all()),
            f"decentralized_serve: tokens {toks}")
        loss = np.asarray(out["report"].trajectory["loss_mean"])
        require(np.isfinite(loss).all(), "decentralized_serve: loss")
        return dict(final_loss=float(loss[-1]), tokens=toks[0].tolist())
    if name == "fault_tolerance":
        require(abs(out["mass"] - 1.0) < 1e-5, "fault_tolerance: mass")
        return dict(mass=out["mass"], error=out["error"])
    if name == "observability":
        require(out["alerts"] == [] and out["events"] > 0,
                f"observability: {len(out['alerts'])} alerts, "
                f"{out['events']} events")
        return dict(events=out["events"], profile_note=out["profile"].note,
                    profile_phases=out["profile"].phases)
    for row in out:  # privacy_sweep's rows
        r = row["result"]
        require(0.0 <= r.accuracy <= 1.0 and math.isfinite(r.loss),
                f"privacy_sweep: {row}")
        require(not row.get("flagged", False),
                f"privacy_sweep: the audit flagged {row}")
    return dict(rows=[dict(algorithm=row["algorithm"], b=row["b"],
                           accuracy=row["result"].accuracy,
                           eps_total=row["result"].eps_total,
                           eps_emp=row.get("eps_emp")) for row in out])


def attention_check(torch, ops, dev) -> dict:
    """``attention_train(use_flash=True)`` at llama3.2-1b's width against
    ``use_flash=False`` on the same card tensors (atol 1e-5, rtol 1e-4);
    the flash launch is the entry point's kernel route, counted here and
    kept out of the kernels line (a comparison)."""
    from repro_torch.models.attention import attention_train, init_attention

    b, s, dm, h, k, d, theta = EXAMPLE_ATTN
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = init_attention(gen, dm, h, k, d, device=dev)
    x = torch.randn((b, s, dm), generator=gen, device=dev)
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    heads = dict(n_heads=h, n_kv_heads=k, head_dim=d, theta=theta)
    with torch.no_grad():
        ops.reset_launch_counts()
        got = attention_train(params, x, pos, use_flash=True, **heads)
        torch.cuda.synchronize()
        launches = ops.launch_counts()["flash_attention"]
        want = attention_train(params, x, pos, use_flash=False, **heads)
    err = float((got - want).abs().max())
    require(launches == 1, f"attention_train(use_flash=True) launched "
                           f"flash_attention {launches} times")
    require(torch.allclose(got, want, atol=1e-5, rtol=1e-4),
            f"attention_train: flash against plain max abs err {err}")
    return dict(shape=dict(zip(("b", "s", "d_model", "h", "k", "d"),
                               EXAMPLE_ATTN[:6])),
                flash_launches=launches, max_abs_err=err)


def profiler_probe(torch, api, ops, dev) -> dict:
    """Whether the port or ``torch.profiler`` loses device events late in
    a long process (ROADMAP Queue 3 item 2): 3 sparse rounds of the card
    test ``test_profile_attributes_each_kernel_launch_to_its_phase``
    under the profiler in this process, after every other phase. The
    wrappers' counts are their launches; the state against the plain
    route on the card (to 1e-5 of its largest magnitude) shows the
    kernels ran; the trace's
    kernels of the port's namespace are what the profiler kept."""
    from repro_torch.net import ErdosRenyiGraph

    topo = ErdosRenyiGraph(24, p=8 / 24, seed=0)
    values = {"x": torch.randn((24, 300_001), device=dev,
                               generator=torch.Generator(
                                   device=dev).manual_seed(SEED))}
    states = {}
    for kernels in (True, False):
        session = api.Session.build(
            topo, privacy=api.PrivacySpec(b=5.0, gamma_n=1e-4),
            schedule="sparse", sync_interval=0, seed=3, use_kernels=kernels)
        if kernels:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                rep = session.run(3, values=values)
                torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            seen = {}
            for e in prof.events():
                if ("repro_torch::" in e.name and e.device_type
                        != torch.autograd.DeviceType.CPU):
                    seen[e.name] = seen.get(e.name, 0) + 1
        else:
            rep = session.run(3, values=values)
        states[kernels] = rep.state.push.s["x"]
    # the kernel route against the plain one, to 1e-5 of the state's
    # largest magnitude (3 noised rounds; the mix and the norms sum in
    # their own orders)
    err = float((states[True] - states[False]).abs().max())
    scale = float(states[False].abs().max())
    require(err <= 1e-5 * scale, f"profiler probe: the kernel route is "
                                 f"{err} from the plain one (max {scale})")
    return dict(process_s=time.perf_counter() - PROCESS_T0,
                max_abs_err=err, max_abs=scale,
                profiled_s=seconds, launched=counts,
                launched_total=sum(counts.values()),
                traced=seen, traced_total=sum(seen.values()))


def examples_phase(torch, api, ops, dev) -> tuple[dict, list]:
    """35: the six ``examples_torch`` scripts on the card, each through its
    ``main(argv)`` (stdout kept apart: its last lines in the record), the
    launch counts set to 0 just before each and read just after, each
    script's kernels required; then ``attention_train`` with flash against
    without, and the profiler probe."""
    import contextlib
    import gc
    import io

    t_phase = time.perf_counter()
    runs, counts = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, expected in EXAMPLE_RUNS:
            argv = [a.format(tmp=tmp) for a in argv]
            module = load_example(name)
            text = io.StringIO()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(text):
                out = module.main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = ops.launch_counts()
            require_launches(launches, expected, f"examples_torch/{name}.py")
            counts.append(launches)
            runs[name] = dict(argv=argv, seconds=seconds,
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                              launches={k: v for k, v in launches.items()
                                        if v},
                              stdout_tail=text.getvalue().splitlines()[-4:],
                              **example_checks(name, out))
            del out, module
            gc.collect()
            torch.cuda.empty_cache()
    attention = attention_check(torch, ops, dev)
    probe = profiler_probe(torch, api, ops, dev)
    return dict(phase="examples", runs=runs, attention_train=attention,
                profiler_probe=probe,
                seconds=time.perf_counter() - t_phase), counts


def kernel_entry(name: str, r: dict, launches: int, **extra) -> dict:
    meta = KERNELS[name]
    return dict(name=name, route="cuda", source=meta["source"],
                replaces=meta["replaces"], launches=launches,
                max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                bound_by=r["bound"][1], library_ms=r["library_ms"], **extra)


HOST_DEVICE_KEYS = ("host_us", "device_us", "kernels_a_call",
                    "library_host_us", "library_device_us",
                    "library_kernels_a_call", "copy_ms", "copy_host_us",
                    "copy_device_us", "copy_kernels_a_call", "plan",
                    "library", "library_max_abs_err", "sparse_mm_ms",
                    "sparse_mm_max_abs_err", "sparse_mm_agrees")


def at_shape(r: dict) -> dict:
    return dict(max_abs_err=r["max_abs_err"], ms=r["ms"],
                plain_ms=r["plain_ms"], bound_ms=r["bound"][0],
                bound_by=r["bound"][1], library_ms=r["library_ms"],
                **{k: r[k] for k in HOST_DEVICE_KEYS if k in r})


def row_block_shapes(blocks: dict) -> dict:
    """Phase 30b's entries of one kernel, each with its block's shape."""
    keys = ("n", "d", "d_s", "b", "k", "node0", "ranks", "edges", "senders",
            "equals_full_rows")
    return {name: dict(at_shape(r), **{k: r[k] for k in keys if k in r})
            for name, r in blocks.items()}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", type=Path, default=None,
                        help="directory for the compiler's full report")
    parser.add_argument("--obs-phase", default=None, metavar="JSON",
                        help="run phase 28 alone with these keyword "
                             "arguments (the whole run starts it so)")
    parser.add_argument("--tp-rank", default=None, metavar="JSON",
                        help="run one rank of phase 31b with these keyword "
                             "arguments (the whole run starts them so)")
    parser.add_argument("--train-rank", default=None, metavar="JSON",
                        help="run one rank of phase 32b-c with these keyword "
                             "arguments (the whole run starts them so)")
    parser.add_argument("--groups-rank", default=None, metavar="JSON",
                        help="run one rank of phase 33b-c with these keyword "
                             "arguments (the whole run starts them so)")
    parser.add_argument("--rest-rank", default=None, metavar="JSON",
                        help="run one rank of phase 34b-c with these keyword "
                             "arguments (the whole run starts them so)")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: run it from the repository root (src/repro_torch "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import api
    from repro_torch.core import topology as T
    from repro_torch import data
    from repro_torch.kernels import build, ops, ref
    from repro_torch.models import mlp

    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if args.tp_rank is not None:
        torch.cuda.set_device(dev)
        build.build_all()  # built by the parent: loads the libraries
        tp_rank(torch, ops, ref, dev, **json.loads(args.tp_rank))
        return 0
    if args.train_rank is not None:
        torch.cuda.set_device(dev)
        build.build_all()  # built by the parent: loads the libraries
        train_tp_rank(torch, ops, dev, **json.loads(args.train_rank))
        return 0
    if args.groups_rank is not None:
        torch.cuda.set_device(dev)
        build.build_all()  # built by the parent: loads the libraries
        groups_rank(torch, ops, ref, dev, **json.loads(args.groups_rank))
        return 0
    if args.rest_rank is not None:
        torch.cuda.set_device(dev)
        build.build_all()  # built by the parent: loads the libraries
        rest_rank(torch, ops, ref, dev, **json.loads(args.rest_rank))
        return 0
    if args.obs_phase is None:
        emit(dict(phase="precision",
                  matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
                  cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
                  float32_matmul_precision=(
                      torch.get_float32_matmul_precision())))
    torch.cuda.set_device(dev)
    if args.obs_phase is not None:
        build.build_all()  # built by the parent: loads the libraries
        out, counts = obs_phase(torch, api, T, ops, dev,
                                **json.loads(args.obs_phase))
        print(json.dumps({"out": out, "counts": counts}), flush=True)
        return 0

    t0 = time.perf_counter()
    report = build.build_all()
    build_s = time.perf_counter() - t0
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "ptxas.txt").write_text("\n".join(
            f"== {k}\n{v['ptxas']}" for k, v in report.items()))
    # ptxas's registers and spills of four kernels (pushsum_mix: both of its
    # kernels, every instantiation); flash's, spmm's and the mix tiles'
    # shared memory is dynamic (flash and the mix tiles: here; spmm: in
    # each plan below)
    brief = {k: ptxas_brief(ptxas_summary(report[k]["ptxas"], kernel))
             for k, kernel in (("pushsum_mix", "mix_"),
                               ("l1_norm", "l1_norm_kernel"),
                               ("dpps_perturb", "perturb_kernel"),
                               ("flash_attention", "flash_attention_kernel"))}
    emit(dict(phase="build", seconds=build_s, kernels={
        k: {"seconds": v["seconds"], "cached": v["cached"]}
        for k, v in report.items()}, ptxas={
        k: ptxas_summary(report[source]["ptxas"], kernel)
        for k, source, kernel in (
            ("flash_attention", "flash_attention", "flash_attention_kernel"),
            ("spmm", "spmm", "spmm_"),
            ("pushsum_mix_tiles", "pushsum_mix", "mix_tile_kernel"),
            ("dpps_perturb", "dpps_perturb", "perturb_kernel"))},
        ptxas_brief=brief,
        flash_dynamic_smem_bytes={
            d: ops.flash_geometry(1, 1, 1, d)["smem_bytes"]
            for d in ops.FLASH_HEAD_DIMS},
        mix_dynamic_smem_bytes={
            tile: ops.mix_plan(33, 1, 1, tile)["smem_bytes"]
            for tile in ops.MIX_TILES}))
    for k, b in brief.items():
        # a library built by an earlier process of this checkout has no report
        require(report[k]["cached"] or b["instantiations"] > 0,
                f"no ptxas report for {k}")
        require(b["spill_bytes"] == 0, f"{k} spills: {b}")

    paper = check_kernels(torch, ops, ref, PAPER, dev, iters=200, cols=1 << 20)
    stats = philox_statistics(torch, ops, dev)
    full = check_kernels(torch, ops, ref, FULL, dev, iters=5, cols=1 << 25)
    torch.cuda.empty_cache()
    # the sparse paths' shapes: pad lanes past 2^31 elements at full width
    sparse_full = check_kernels(torch, ops, ref, SPARSE_FULL, dev, iters=5,
                                cols=1 << 22, mix=False)
    torch.cuda.empty_cache()
    sparse_train = check_kernels(torch, ops, ref, SPARSE_TRAIN, dev,
                                 iters=200, cols=1 << 20, mix=False)
    torch.cuda.empty_cache()
    # the training path's buffer: llama3.2-1b's shared layers, N = 4
    train_full = check_kernels(torch, ops, ref, TRAIN_FULL, dev, iters=5,
                               cols=1 << 25)
    torch.cuda.empty_cache()
    spmm = {
        "full": check_spmm(torch, ops, ref, sparse_graph(SPARSE_FULL["n"]),
                           d_pad_of(SPARSE_FULL["d_s"]), dev, iters=5,
                           cols=1 << 24),
        "train": check_spmm(torch, ops, ref, sparse_graph(SPARSE_TRAIN_N),
                            d_pad_of(PAPER["d_s"]), dev, iters=200,
                            cols=1 << 20),
        "sweep": check_spmm(torch, ops, ref, sparse_graph(
            SPARSE_SWEEP["n"], SPARSE_SWEEP["seed"]), SPARSE_SWEEP["d"], dev,
            iters=200, cols=1 << 20),
    }
    # host µs before any profiler session in this process; device µs after
    # every timed path
    small = {"paper": paper, "sparse_train": sparse_train}
    calls = small_shape_calls(torch, ops, dev)
    for (shape, k), (fn, other, name) in calls.items():
        small[shape][k].update({"host_us": host_us(torch, fn),
                                f"{name}_host_us": host_us(torch, other)})
    emit(dict(phase="kernels", paper_shape=PAPER, full_shape=FULL,
              sparse_full_shape=SPARSE_FULL, sparse_train_shape=SPARSE_TRAIN,
              training_shape=TRAIN_FULL,
              philox=stats, results={"paper": paper, "full": full,
                                     "sparse_full": sparse_full,
                                     "sparse_train": sparse_train,
                                     "training": train_full, "spmm": spmm}))

    launches = []
    cons = consensus(torch, api, T, ops, dev, topo=T.DOutGraph(FULL["n"], 2),
                     shape=FULL, schedule="dense", phase="consensus",
                     expected=DENSE_PATH)
    emit(cons)
    launches.append(cons["launches"])
    torch.cuda.empty_cache()
    batches = training_batches(mlp, data, torch, 10, TRAIN_STEPS)
    topo = T.DOutGraph(10, 2)
    train, (card, rep) = training(
        torch, api, mlp, ops, topo=topo, schedule="dense", batches=batches,
        phase="training", expected=DENSE_PATH)
    emit(train)
    launches.append(train["launches"])
    trained = {"dense": (topo, "dense", batches, card, rep)}

    scons = consensus(torch, api, T, ops, dev,
                      topo=sparse_graph(SPARSE_FULL["n"]), shape=SPARSE_FULL,
                      schedule="sparse", phase="sparse_consensus",
                      expected=SPARSE_PATH, absent=("pushsum_mix",))
    emit(scons)
    launches.append(scons["launches"])
    torch.cuda.empty_cache()
    batches = training_batches(mlp, data, torch, SPARSE_TRAIN_N, TRAIN_STEPS)
    topo = sparse_graph(SPARSE_TRAIN_N)
    strain, (card, rep) = training(
        torch, api, mlp, ops, topo=topo, schedule="sparse", batches=batches,
        phase="sparse_training", expected=SPARSE_PATH,
        absent=("pushsum_mix",))
    emit(strain)
    launches.append(strain["launches"])
    trained["sparse"] = (topo, "sparse", batches, card, rep)

    tree, tree_results = tree_ops(torch, ops, ref, dev)
    emit(tree)
    launches.append(tree["launches"])
    emit(agreement(torch, api, T, mlp, trained))
    del trained, card, rep
    torch.cuda.empty_cache()

    flash = {name: check_flash(torch, F, ops, ref, name, dev,
                               iters=3 if FLASH_SHAPES[name][1] > 4096 else 20)
             for name in FLASH_SHAPES}
    emit(dict(phase="flash", results=flash))
    for arch in ("llama3.2-1b", "gemma3-1b"):
        served = serve(torch, ops, dev, arch)
        emit(served)
        launches.append(served["launches"])
    emit(serve_agreement(torch, ops, dev))
    torch.cuda.empty_cache()

    wide = mix_wide(torch, ops, ref, dev)
    emit(wide)
    er = dense_er4096(torch, api, T, ops, dev)
    emit(er)
    launches += [er["launches"], er["sparse_schedule"]["launches"]]
    rows = rows_wide(torch, ops, ref, dev)
    emit(rows)
    lm = transformer_training(torch, ops, T, dev)
    emit(lm)
    launches.append(lm["launches"])
    emit(training_agreement(torch, ops, ref, T, dev))
    torch.cuda.empty_cache()
    for arch, cut in GROUP_SERVE.items():
        served = serve(torch, ops, dev, arch, prompt=GROUP_SERVE_PROMPT,
                       cut=cut)
        emit(served)
        launches.append(served["launches"])
    emit(group_serve_agreement(torch, ops, dev))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        trained, memory = group_training(torch, ops, T, dev, ckpt_dir)
        emit(trained)
        launches.append(trained["launches"])
        served = checkpoint_serve(torch, ops, dev, ckpt_dir, memory)
        emit(served)
        launches.append(served["launches"])
        del memory
    emit(group_training_agreement(torch, ops, ref, T, dev))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        looped, session, lm_batches, counts = loop_training(
            torch, api, mlp, data, ops, ref, T, dev, tmp)
        emit(looped)
        launches += counts
        del session, lm_batches
        torch.cuda.empty_cache()
        session, lm_batches, _ = lm_session(torch, T, layers=RESUME_LAYERS)
        resumed = resume(torch, ops, session, lm_batches, tmp)
        emit(resumed)
        launches.append(resumed["launches"])
        del session, lm_batches
    torch.cuda.empty_cache()
    dry_procs, groups_dry, rest_dry, dry_tmp, dry_t0 = dry_runs_start()
    faulted, counts = faults_phase(
        torch, api, mlp, data, ops, ref, T, dev,
        dense_ms=cons["ms_per_round"], sparse_ms=scons["ms_per_round"])
    emit(faulted)
    launches += counts
    with tempfile.TemporaryDirectory() as tmp:
        delayed, counts = async_phase(torch, api, mlp, data, ops, T, dev, tmp)
    emit(delayed)
    launches += counts
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        wired, counts = wire_phase(
            torch, api, mlp, data, ops, T, dev, tmp,
            f32_ms=cons["ms_per_round"], f32_step_ms=lm["ms_per_step"])
    emit(wired)
    launches += counts
    torch.cuda.empty_cache()
    audited, counts = audit_phase(torch, api, mlp, data, ops, dev)
    emit(audited)
    launches += counts
    torch.cuda.empty_cache()
    observed, counts = obs_subprocess(
        torch, dense=cons["round_breakdown_ms"],
        sparse=scons["round_breakdown_ms"],
        mlp_ms={"dense": train["ms_per_step"],
                "sparse": strain["ms_per_step"]},
        er_ms=er["ms_per_round"])
    emit(observed)
    launches += counts

    for (shape, k), (fn, other, name) in calls.items():
        r = small[shape][k]
        r["device_us"], r["kernels_a_call"] = device_us(torch, fn)
        r[f"{name}_device_us"], r[f"{name}_kernels_a_call"] = device_us(
            torch, other)
    smi = card_line()
    # phase 29: the TRAIN_LM step on the card and the dry run's rows (its
    # processes started before phase 24); then the serve rows the dry run
    # says fit
    trained, counts = launch_train(torch, ops, dev, smi)
    dry, dry_rows = dryrun_finish(dry_procs, dry_tmp, dry_t0, smi)
    if args.out is not None:
        (args.out / "dryrun.json").write_text(json.dumps(dry_rows, indent=1))
    emit(dry)
    emit(trained)
    lm_step = trained
    launches.append(counts)
    served, counts = launch_serve(torch, ops, dev, dry_rows, smi)
    emit(served)
    launches += counts
    sharded, counts, blocks = shard_phase(torch, api, mlp, data, T, ops, ref,
                                          dev)
    emit(sharded)
    launches += counts
    axis_line, counts, tp_flash = model_axis_phase(torch, ops, ref, dev, smi)
    emit(axis_line)
    launches += counts
    train_line, counts, strided = model_axis_train_phase(torch, ops, ref,
                                                         dev, smi, lm_step)
    emit(train_line)
    launches += counts
    groups_line, counts, groups_flash, groups_strided = \
        model_axis_groups_phase(torch, ops, ref, dev, smi, dry_rows,
                                (groups_dry, dry_tmp))
    emit(groups_line)
    launches += counts
    rest_line, counts, rest_flash = rest_axis_phase(
        torch, ops, ref, dev, smi, (rest_dry, dry_tmp))
    emit(rest_line)
    launches += counts
    examples_line, counts = examples_phase(torch, api, ops, dev)
    emit(examples_line)
    launches += counts
    total = {k: sum(path[k] for path in launches) for k in KERNELS}
    kernels = []
    for name in DENSE_PATH:
        f, p = full[name], paper[name]
        at = {"paper_shape": at_shape(p),
              "training_shape": dict(at_shape(train_full[name]), **TRAIN_FULL)}
        if name in SPARSE_PATH:
            at.update(sparse_full_shape=at_shape(sparse_full[name]),
                      sparse_train_shape=at_shape(sparse_train[name]))
        if name == "pushsum_mix":
            at.update({f"wide_{k}_shape": dict(at_shape(r), n=r["n"], d=r["d"],
                                               plan=r["plan"])
                       for k, r in wide["results"].items()})
        else:
            at.update({f"rows_wide_{k}_shape": at_shape(r[name])
                       for k, r in rows["results"].items()})
        at.update(row_block_shapes(blocks.get(name, {})))
        extra = {}
        if name == "pushsum_mix":  # phase 24a's realized W
            extra["realized_weights"] = faulted["dense_full"]["realized_mix"]
        norms = {}
        if name == "dpps_perturb_rows":  # phase 32's strided launches
            at["model_axis_strided_shape"] = dict(
                at_shape(strided["main"]), **{
                    k: strided["main"][k] for k in (
                        "n", "lead", "width", "block", "col0", "run",
                        "stride", "off", "contiguous_ms", "pct_of_bound",
                        "vs_contiguous", "mapped_launches")})
            norms = {"norm_only_launches": total["noise_l1_rows"],
                     "model_axis_straddling_maps": {
                         k: v for k, v in strided.items() if k != "main"},
                     "model_axis_groups_strided_launches": groups_strided}
        kernels.append(kernel_entry(
            name, dict(f, max_abs_err=max(
                [f["max_abs_err"]] + [a["max_abs_err"] for a in at.values()]
                + [r["max_abs_err"] for r in extra.values()])),
            total[name], shape=dict(FULL, d_pad=d_pad_of(FULL["d_s"])),
            **{k: f[k] for k in ("plan", "copy_ms") if k in f}, **at,
            **extra, **norms))
    sp = spmm["full"]
    realized = faulted["sparse_full"]["realized_mix"]  # phase 24b's
    sp_blocks = row_block_shapes(blocks["spmm"])
    kernels.append(kernel_entry(
        "spmm", dict(sp, max_abs_err=max([r["max_abs_err"]
                                          for r in spmm.values()]
                                         + [realized["max_abs_err"]]
                                         + [r["max_abs_err"]
                                            for r in sp_blocks.values()])),
        total["spmm"],
        shape=dict(n=sp["n"], d=sp["d"], k=sp["k"], edges=sp["edges"]),
        **{k: sp[k] for k in ("library", "library_max_abs_err",
                              "sparse_mm_ms", "sparse_mm_max_abs_err",
                              "sparse_mm_agrees")},
        realized_weights=realized,
        regime=sp["plan"]["regime"],
        train_shape=dict(at_shape(spmm["train"]), n=spmm["train"]["n"],
                         d=spmm["train"]["d"], k=spmm["train"]["k"],
                         regime=spmm["train"]["plan"]["regime"]),
        sweep_shape=dict(at_shape(spmm["sweep"]), n=spmm["sweep"]["n"],
                         d=spmm["sweep"]["d"], k=spmm["sweep"]["k"],
                         regime=spmm["sweep"]["plan"]["regime"]),
        **sp_blocks))
    for name in ("clip_scale_rows", "laplace_from_bits"):
        extra = {} if name != "clip_scale_rows" else {
            f"rows_wide_{k}_shape": at_shape(r[name])
            for k, r in rows["results"].items()}
        kernels.append(kernel_entry(
            name, tree_results[name], total[name],
            shape=dict(SPARSE_FULL, d_pad=d_pad_of(SPARSE_FULL["d_s"])),
            **extra))
    fa = flash["llama_32k"]
    kernels.append(kernel_entry(
        "flash_attention",
        dict(fa, max_abs_err=max([r["max_abs_err"] for r in flash.values()]
                                 + [r["max_abs_err"] for r in
                                    tp_flash + groups_flash + rest_flash])),
        total["flash_attention"], shape=fa["shape"],
        model_axis_rank_shards=tp_flash + groups_flash + rest_flash,
        max_rel_err=max(r["max_rel_err"] for r in flash.values()),
        pct_of_bound=fa["pct_of_bound"],
        f32_core_bound_ms=fa["f32_core_bound_ms"],
        **{f"{name}_shape": dict(at_shape(r), shape=r["shape"],
                                 max_rel_err=r["max_rel_err"],
                                 pct_of_bound=r["pct_of_bound"],
                                 f32_core_bound_ms=r["f32_core_bound_ms"])
           for name, r in flash.items() if name != "llama_32k"}))
    print(smi, flush=True)
    emit({"kernels": kernels, "card": smi})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
