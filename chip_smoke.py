#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (target: H100 SXM).

    python3 chip_smoke.py

Phases, each printing its own lines and seconds:

1. environment: the card's name and power limit (nvidia-smi), torch,
   and the TF32 flags the package sets;
2. build: nvcc builds the CUDA kernels from this checkout's sources, one
   nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card,
   at the paper's MNIST-like 784 × 50 000 and SVHN-like 3072 × 99 288
   shapes (benchmarks/bench_sequential.py), ``screen_matvec`` also on the
   ``*_cut`` screens' stacked rows (2 for one query, 16 for a batch of 8:
   two launches, timed as the pair the path pays) and on the bf16 screen
   copy X̂ (1, 8 and 16 rows and the SVHN width, beside
   ``torch.matmul(c.bfloat16(), X̂)``), narrow solver buckets and a
   ragged shape; ``fista_step`` also on a bf16 solve bucket (784 × 32,
   784 × 128 at B = 8 with a ready (3, B) block, each row the bits of its
   query's single launch, 784 × 512 on a cluster, 777 × 1 001 on scalar
   loads), beside ``torch.matmul(r.bfloat16(), X̂)``; the Gram CD sweep at buckets of 32, 256 and 1024
   columns for 1 and 8 queries (and 8 with a ``valid`` mask), each beside
   its chain bound (sweeps·p × the latency of one dependent step, timed
   on a one-warp kernel of ``csrc/cd_gram.cu`` that runs the step's
   arithmetic without loads); the group scores at the paper's
   250 × 200 000 group design (benchmarks/bench_group.py) for m = 5, 10,
   20 and 200 (a group wider than a tile) and at 777 × 1 000 (m = 5) and
   777 × 1 001 (m = 7, scalar loads), each with its launch plan; the
   prox step at p = 50 000 for 1 and 8 queries and a ragged p = 1 003 for
   3 queries with per-query parameters, and on a stack of 4 gradient
   parts with its parameters in a (3, B) device block at the same shapes
   (bit for bit its plain version; ``torch.sum`` over the parts beside
   it), each also per launch in a run of 25 launches from Python and
   replayed from a CUDA graph of 25, beside a 1-element ``zero_()``
   timed the same two ways; with times (CUDA events, median
   of 20) beside the byte/flop bound and a torch.matmul yardstick. For
   the three column-pass kernels each row also prints its launch plan
   (grid, block, cluster, vector width, staged rows), the registers and
   spills of the kernel it launches (``-Xptxas -v``), its share of the
   bound and its ratio to torch.matmul; ``fista_step`` prints the launch
   floor (a 1-element ``zero_()`` timed the same way) beside it, and is
   timed at 784 × 32 and 784 × 512 with the rows split over clusters of
   8, 4, 2 and 1 CTAs, in turns, on zero rows, and per launch in runs of
   back-to-back launches beside torch.matmul and ``zero_()``;
4. main path: ``LassoSession.fit(X)`` then ``session.path(y,
   num_lambdas=100)`` with the default config at 784 × 50 000, with
   every kernel launch counter read just after and the plain versions'
   counters required to stay at 0;
5. exactness: the EDPP path against the unscreened path (tol 1e-6, 20 λ);
6. CD path: the same data and session entry points with
   ``SolveSpec(strategy="cd", tol=1e-6)``, 100 λ: every solve converged
   before max_epochs, and β held against the FISTA EDPP path at the same
   tol (beta_err_tol and CD_REL_TOL·max|β_fista|);
7. group path: ``LassoSession.fit(X, groups=10)`` and group EDPP at tol
   1e-6, 100 λ, on the paper's 250 × 200 000 design with 20 000 groups;
8. group exactness: group EDPP and group strong against the unscreened
   group path on its grid at 250 × 20 000 (m = 10; the unscreened arm
   solves every column each iteration, so this phase runs at a tenth of
   the width): no unsafe group discard, β within beta_err_tol and
   GROUP_REL_TOL·max|β_none|;
9. distributed: a process group of one rank over NCCL (a HashStore, the
   card as its device) and a (1, 1) ``("query", "feature")`` mesh, on the
   784 × 50 000 data at full width: ``LassoSession.fit(X, mesh=mesh)``
   and a 100-λ path (tol 1e-6, hi_frac 0.95) against the unsharded
   session (masks, β, passes equal); ``lambda_max_d`` against the
   session's λ_max; the three single-query ``dist_edpp_screen*`` at
   0.5·λ_max from β = 0 against the engine's EDPP mask;
   ``dist_power_iteration`` against ‖X‖₂²; ``dist_fista`` ``"none"`` and
   ``"chunked"`` (FISTA_ITERS iterations at 0.3·λ_max, from β = 0 and
   from a dense start), each replayed from CUDA graphs and run eagerly
   (``capture=False``), with ms per iteration: captured β bit for bit
   the eager β, the modes against each other and an unsharded solve at
   tol 1e-8, and the pieces of one iteration of each mode timed in a
   graph; ``dist_fista_batched`` and ``dist_edpp_screen_batched`` at
   B = 8 against 8 single-query runs; the (8, n) batch of those queries
   through the mesh session against the unsharded session (masks,
   n_discarded, x_passes equal, max|Δβ| ≤ 1e-6·max|β|); then ``gap_cut``
   (100 λ) and ``dome`` (25 λ) paths on the mesh session against the
   unsharded one (the same checks, and the ``screen_matvec`` launches per
   screen);
   the group is torn down after;
10. batched path: ``QueryStream(n=784, p=50 000, batch=8, nnz=16,
   sigma=0.05, seed=0)``, ``LassoSession.fit(X)`` then ``path(Y)`` with
   Y (8, n), 100 λ per query (``hi_frac=0.95``), EDPP, FISTA at tol 1e-6:
   against 8 single-query runs of the same session on the same grids
   (masks equal outside the ±1e-4 band of the threshold, band columns
   counted; β within beta_err_tol per query), ``screen_matvec`` launched
   at most once per live step plus the |Xᵀy| attach, the union bucket per
   decile and the batched wall beside the single runs' walls; the same
   batch with ``strategy="cd"`` (every step on ``cd_gram_sweep`` at B = 8
   with ``valid``, every solve converged, β within beta_err_tol and
   CD_REL_TOL·max|β| of the FISTA arm); and one EDPP screen at B = 12 (two
   launches), masks and dots bit for bit the 12 single-query screens.
   The group exactness phase also holds a (2, n) group batch bit for bit
   against its two single runs;
11. serve: ``repro_torch.launch.serve.main`` in-process, as a user runs
   ``python -m repro_torch.launch.serve``, at 784 × 50 000 (``--nnz 16
   --seed 0``, the stream's own σ), 20 queries of 16 λ (``--hi-frac 0.95
   --lo-frac 0.1 --solver-tol 1e-6``), ``--b-max 8 --deadline-ms 20
   --queue-cap 64 --max-in-flight 2``, ``--mode compare --repeats 1
   --check-masks 0`` with the bench JSON in a temporary directory: both
   arms serve 20 of 20 with 0 errors, every served mask equals the direct
   ``session.path`` call on its grid outside the ±1e-4 band of the
   threshold (the queries not bit for bit and their flips counted and
   printed), the fixed arm's trace is
   2 × (fill, 8/8) then (drain, 4/8) and the continuous arm's 2 × (fill,
   8/8) then (deadline or drain, 4/4) (``tail_reason``: the deadline is
   checked first); queries/sec, p50 and p99 of both arms and each
   kernel's launches are printed as readings. Then ``--solver cd --mode
   continuous`` on the same data with 8 queries (one fill batch; cut
   from 44 to 12 to keep the smoke's time when phases 17 and 18 came,
   and to 8, with the compare run's 44 cut to 20, when phase 24 came):
   0 errors, every live step whose union
   bucket has at most min(n, ``GRAM_BUCKET_MAX``) columns on
   ``cd_gram_sweep`` and every wider one on matvec CD (the Gram
   crossover), no ``fista_step``;
12. solve: ``repro_torch.launch.solve.main`` in-process at 784 × 50 000
   (``--no-x64``, 20 λ, the default tol 1e-8) with ``--ckpt-dir``: the
   latest checkpoint is step 19, holds the result's last β, and only the
   newest 3 steps are kept; then ``--group-size 10`` at 250 × 20 000,
   which launches ``group_screen_scores``;
13. rules: the other screening rules at 784 × 50 000 on phase 4's data,
   every arm a counted path ending in a device sync (the plain versions
   uncalled, ``backend_name == "cuda"``): (a) the paper's Fig. 2 basic
   rules ``safe``, ``dome``, ``strong``, ``edpp`` (``sequential=False``)
   on unit-normalised columns and y, 20 λ (cut from 100 to keep the
   smoke near its earlier time once phase 14 was added, then from 50
   once phase 24 was), tol 1e-6;
   (b) ``gap``,
   ``strong``, ``edpp_cut``, ``gap_cut`` and hybrid ``edpp`` +
   ``strong`` on the default data, 100 λ — each printing its discard
   fraction per decile, x_passes per live step (held to the engine's
   count), ``screen_matvec`` launches per screen, KKT rounds and wall;
   (c) every new rule on phase 5's 20-λ grid against its unscreened β
   (max|Δβ| ≤ beta_err_tol(y, 1e-6), no discarded feature that the
   unscreened solution needs, after the KKT loop for the strong rule and
   hybrid), and each ``*_cut`` screen ⊇ its base screen at every step,
   from the states of the base's path where (c) ran one (``gap``), else
   of the cut's own path (any state will do: the two screens share its
   sphere; the base paths of ``dpp``, ``imp1``, ``imp2``, ``edpp`` and
   ``seq_safe`` were run for their states until phase 24 came); (d)
   ``gap``, ``edpp_cut`` and ``strong`` on phase 10's batch against 8
   single runs (masks outside the ±1e-4
   band of the thresholds the single run tested, flips counted; β within
   beta_err_tol; a GAP flip may also be explained by the two paths' own
   states, since its radius is the duality gap each solve stopped at,
   and GAP's band is widened by its radius' float32 rounding);
14. bf16 screen (``screen_dtype="bfloat16"``) at 784 × 50 000: the
   float32 re-test's dots (gathers of 8, 24 and 48 columns, 16 rows,
   launched with ``wide_p``) bit for bit the wide pass's; the 100-λ EDPP
   path (tol 1e-6) in bf16 against float32, both counted after
   ``reset_solver_cache()`` (``screen_matvec_bf16`` launched, no plain
   version called): masks equal at every step, and per tenth of the grid
   the re-tested columns, passes, screen bytes and screen seconds of both
   arms; every rule of ``BF16_FAST_RULES`` on phase 5's 20-λ grid against
   its own float32 arm, both at ``BF16_RULE_MAX_ITER`` iterations a step
   (cut from 5 000 when phase 24 came); phase 10's B = 8 batch
   with ``edpp``, ``gap`` and ``edpp_cut`` against its float32 batch;
   ``solve --screen-dtype bfloat16`` (20 λ) against phase 12's solve;
16. bf16 solve (``solve_dtype="bfloat16"``, run after phase 14) at
   784 × 50 000, every arm counted after ``reset_solver_cache()``: (a)
   the 100-λ EDPP path at tol 1e-6 against its float32 arm, (b) with
   ``screen_dtype`` bf16 too, (c) ``strategy="cd"`` in bf16 against the
   float32 CD arm (``cd_gram_sweep`` launched, no ``fista_step_bf16``;
   CD_REL_TOL), (d) phase 10's B = 8 batch in bf16 against its float32
   batch, (e) ``solve --solve-dtype bfloat16`` (20 λ) against phase 12's
   solve; masks equal outside the ±1e-4 band of every EDPP threshold
   either path tested, or on a column the two paths' own states put on
   opposite sides (flips counted), β within beta_err_tol, every live
   step on the bf16 stream with bf16-phase iterations (a cd bucket past
   the Gram crossover: float32), ``fista_step_bf16`` launched in (a),
   (b), (d) and (e); per tenth of the grid the bf16-phase and total
   iterations, the solve bytes and seconds of each arm;
17. mesh bf16 (run after 16): a process group of one rank over NCCL and
   a (1, 1) mesh at 784 × 50 000, 100 λ (``hi_frac`` 0.95, tol 1e-6),
   every arm counted after ``reset_solver_cache()``: (a) the mesh
   session's bf16 screen against its float32 arm (masks bit for bit at
   every step, ``screen_matvec_bf16`` launched), (b) bf16 ``fista``, (c)
   bf16 ``cd`` and (d) a B = 8 batch (y and 7 more queries of
   make_dataset's recipe) on the mesh, each against the unsharded
   bf16-solve arm (masks outside the ±1e-4 band or across the two
   states, flips counted; β within beta_err_tol; bf16-phase iterations;
   ``fista_step_bf16`` launched in (b) and (d)); (e) ``solve --mesh 1x1
   --screen-dtype bfloat16 --solve-dtype bfloat16`` (20 λ) on its own
   one-rank NCCL group against phase 12's solve;
18. updates: ``LassoSession.fit(X)`` with its bf16 copy and bound made
   and a live B = 8 ``PathWorkspace``, then three balanced rounds at
   ``benchmarks/bench_update.py``'s 5 % churn (2 500 columns dropped,
   2 500 added), an append of 64 columns and a compacting drop of 64,
   each through ``session.update(..., workspaces=[ws])`` timed to a
   device sync and counted (``edpp_screen_scores`` and ``screen_matvec``
   launched, no plain version); after each, the oracle-refit contract
   against a cold ``fit`` of the edited X (timed the same way, with its
   bf16 copy, bound and workspace attach): X, ‖x_j‖², ‖x_j‖, the bf16
   copy, its bound, the workspace's |Xᵀy|, argmax and λ_max bit for bit,
   then a 20-λ EDPP path of each at 500 iterations a step
   (``UPDATE_LAMBDAS``, ``UPDATE_MAX_ITER``, cut from 100 and 5 000 when
   phase 24 came) after ``reset_solver_cache()``: masks bit for bit, β
   within beta_err_tol; then on a (1, 1) NCCL mesh a balanced edit and a
   mixed one (64 dropped, 128 added) against the unsharded session's same
   update (arrays and 20-λ masks bit for bit),
   with the bytes the relayout received. Phase 3 adds the fused pass on
   2 500 columns launched with ``wide_p=50 000``: ‖x_j‖² and scores bit
   for bit the full pass's at those columns, and its row against the
   plain version;
19. group mesh and the core surface (run after 18), on a process group
   of one rank over NCCL: (a) ``LassoSession.fit(X, groups=10,
   mesh=mesh)`` on a (1, 1) mesh at phase 7's 250 × 200 000 design,
   group EDPP at tol 1e-6 over 100 λ from a reset solver cache: masks,
   n_discarded, x_passes, buckets, β and the spectral norms bit for bit
   phase 7's (kept, not rerun), ``backend_name == "shard:cuda"``,
   ``group_screen_scores`` launched and the plain counters 0; the
   spectral norms of the design's two halves against the whole batch's,
   bit for bit; (b) ``solve --group-size 10 --mesh 1x1`` (250 × 20 000,
   20 λ) bit for bit phase 12's group solve; (c) a (1, 1, 1) ``("query",
   "a", "b")`` mesh at 784 × 50 000, 20 λ, bit for bit the (1, 1) mesh;
   (d) the one-shot ``fista`` (its ``fista_step`` launches counted) and
   ``cd`` on the card at 784 × 1 024 of the main data, 0.3·λ_max, tol
   1e-6, within ``beta_err_tol`` of each other, ``group_fista`` at
   250 × 2 000 of the group design (m = 10), and ``lasso_path`` at 20 λ
   bit for bit ``LassoSession.fit(X).path(y, grid)`` with its
   ``DeprecationWarning``. Phase 3 adds the group pass on the contiguous
   250 × 100 000 half of the group design with ``wide_p = 200 000``: its
   scores bit for bit the full pass's at those groups, its time and
   bound, beside the block's own plan and whether its bits differ;
20. LM stack (run after 19): yi-9b at its published width (d_model 4096,
   32 heads, kv 4, d_head 128, d_ff 11 008, vocab 64 000, SwiGLU, θ 5e6)
   with its depth cut to ``LM_DEPTH`` layers: (a) ``LM_STEPS`` train
   steps of ``repro_torch.train.steps.make_train_step`` (bf16 compute,
   f32 masters, AdamW) on one fixed ``SyntheticLM`` batch at train_4k's
   sequence 4096 and ``LM_BATCH`` sequences: the loss finite and falling
   every step; the parameter count, losses, tokens/s after the first
   step, ``torch.cuda.max_memory_allocated`` and L printed; (b) the state
   saved before the last step (the reference's layout,
   ``train_state_to_reference``), restored leaf for leaf equal, and the
   resumed step's loss against the uninterrupted one's; (c) prefill of
   ``LM_PREFILL`` tokens then ``LM_DECODE`` decode steps (the serving
   steps), in f32 and bf16, against the full forward's logits
   (``LM_DECODE_TOL``); (d) ``python -m repro_torch.launch.train --arch
   yi-9b --tiny --steps 10`` on the card (started before the phase and
   run beside (a)–(c)); (e) the FFN-pruning bridge
   (``examples/prune_ffn_torch.py``) on (a)'s model: layer 0's FFN
   activations on a ``LM_PROBE``-token probe, H (2048 × 11 008), group
   EDPP over neurons (m = 1) against ``rule="none"``, 20 λ down to
   0.02·λ_max at tol 1e-6: ``group_screen_scores`` launched once per
   screen and once for λ̄_max, the plain counters 0, no discarded neuron
   non-zero in the unscreened solution, β within GROUP_REL_TOL·max|β_none|
   and beta_err_tol, and the kept-neurons/R² table printed. Phase 3 adds
   the group pass at m = 1 on 2048 × 11 008 against its plain version;
21. MoE and MLA (run after 20): deepseek-v2-lite-16b at its published
   width (d_model 2048, 16 heads; MLA r 512, d_nope 128, d_rope 64, d_v
   128; 64 routed experts of 1 408, top-6, 2 shared; the dense layer 0
   with d_ff 10 944; vocab 102 400; capacity 1.25 in groups of 128) with
   its 26 MoE layers cut to ``MOE_DEPTH``: (a) ``LM_STEPS`` train steps
   on one fixed batch (phase 20's sequence, batch, rate and bf16
   compute): the loss finite and falling every step; the parameter
   count, losses, tokens/s after step 0, ``max_memory_allocated`` and,
   for each MoE layer, the share of (token, choice) pairs over capacity
   on step 0's forward (the layer's own ``moe_route`` call, recorded);
   (b) prefill of ``LM_PREFILL`` tokens then ``LM_DECODE`` decode steps
   against the full forward at the dropless ``MOE_DROPLESS`` capacity, in
   f32 and bf16 (``LM_DECODE_TOL``; the decoded positions whose expert
   set differs from the forward's counted, and printed in bf16 or on a
   miss); (c) ``python -m repro_torch.launch.train --arch
   moonshot-v1-16b-a3b --tiny --steps 10`` on the card, its losses
   finite (started, with 20(d)'s run, before phase 20, and run beside
   it). No kernel of the six runs in it: ``ops.launch_counts()`` is
   the same before and after;
22. the recurrent architectures (run after 21), each at its published
   width (``SSM_WIDTH``, held on the published config): (a) zamba2-1.2b
   at full depth (38 Mamba2 blocks and 6 applications of the one shared
   attention + FFN block) and (b) xlstm-350m at its first super-block
   of 3 (7 mLSTM and 1 sLSTM blocks of 21 and 3, ``SSM_SUPER``: cut when
   phase 24 came, for the smoke's time; bf16 AdamW moments), each
   ``SSM_STEPS`` train steps on one fixed batch (phase
   20's sequence, batch, rate and bf16 compute): the loss finite, and
   for zamba2 falling every step (xlstm's gradient norm passes the clip
   by 12 orders: ``SSM_STEPS``), the parameter count the reference's
   (``SSM_PARAMS``), the gradient norms, tokens/s after step 0 and
   ``max_memory_allocated``; step 1 bracketed by CUDA events
   (``step_spans``): each block kind's forward and backward milliseconds
   and share of the step, and each mLSTM block's normaliser |n|; for
   xlstm, an mLSTM and an sLSTM block's gradients on the card in f32
   and bf16 against the CPU's (``block_grads``); decode against the
   full forward in f32 and bf16, the whole model (``ssm_decode``: held at
   ``LM_DECODE_TOL`` for ``SSM_DECODE_HELD``, a reading elsewhere) and
   every block on the forward's own input, its caches and outputs held
   at ``LM_DECODE_TOL`` (``block_decode``): zamba2 after a prefill of
   ``LM_PREFILL`` tokens (``pad_caches`` pads its attention caches and
   passes its Mamba2 states through), xlstm token by token from an empty
   cache over ``LM_DECODE`` positions (the mLSTM stabiliser scales a
   prefill's state, in the reference too); (c) (b)'s state saved and
   restored leaf for leaf equal, its bf16 moments bf16 again; (d)
   ``python -m repro_torch.launch.train --arch A --tiny --steps 10`` for
   both, at once, finite losses; (e) the launch and plain-version
   counters the same before and after;
23. the sharded LM step (run after 22, ROADMAP item 14d): a process group
   of one rank over NCCL and a (1, 1) ("data", "model") mesh
   (``nccl_world``); (a) phase 20's config (yi-9b at full width, L = 3,
   seq 4096, batch 4, bf16, lr 1e-4), ``SHARD_STEPS`` steps of
   ``make_train_step(..., mesh)`` from the sharded ``init_state``
   against the unsharded step from the same seed on the same batch:
   losses, gradient norms and every parameter and moment bit for bit,
   each sharded step's collectives by kind, count and bytes (issued at
   world size 1, not skipped), walls and ``max_memory_allocated`` of
   both arms; (b) ``torchrun --standalone --nproc-per-node 1 -m
   repro_torch.launch.train --arch deepseek-v2-lite-16b --tiny --mesh
   1x1`` to step 2, started first and run beside the rest of the phase,
   and ``launch.train.main`` here to step 4 (a one-rank NCCL group of
   its own); after (a) ``main`` here resumes torchrun's checkpoint to
   step 4: its leaves equal the uninterrupted run's; (c) the per-rank
   bytes of f32 masters
   and moments of full-depth yi-9b, deepseek-v2-lite-16b and
   nemotron-4-340b on (1, 1), (16, 16) and (2, 16, 16) from
   ``pshard.resolve_tree`` on meta-device shapes; the launch and
   plain-version counters the same before and after;
24. the dry run (run after 23, ROADMAP item 14e): (a) phase 20's config
   and (b) phase 21's, each traced once by ``repro_torch.launch.dryrun.
   trace_step`` on fake CUDA tensors (nothing allocated) and run once for
   real under the same ``hlo_cost.CostMode``: the counted flops equal;
   a plain step's ``max_memory_allocated`` within ``DRYRUN_PEAK_BAND``
   of the tracked peak; its wall beside the dry run's ``bytes_fused``,
   roofline ``t_compute`` and the step's share of the bf16 peak; (c)
   ``dist_edpp_screen_cached`` and ``dist_fista`` (10 iterations,
   ``"chunked"``, ``capture=False``) at 784 × 50 000 on an NCCL world of
   1 against their dry run on a fake world of 1: each kernel's launches
   equal its charged launches, a ``screen_matvec`` charge's bytes the
   bound column's; (d) ``python -m repro_torch.launch.dryrun`` for
   yi-9b decode_32k and lasso-screen-16m on (16, 16), started first and
   run beside the rest: each record ``ok``, printed on one line. Every
   failure of (a)–(d) is gathered and raised at the end;
25. tensor parallelism over "model" (run after 24, ROADMAP item 14f):
   (a) one real train step of yi-9b at full width and full depth (48
   layers) on ``TP_ROWS`` × 4 096 tokens of train_4k, bf16, as rank 0
   of a fake world of 256 ranks on (16, 16) (``dryrun.fake_world``: the
   collectives move nothing, so the loss is not read), the rank's
   shards drawn from a seeded generator on the card: its
   ``max_memory_allocated`` under ``TP_LIMIT_GB`` and within
   ``DRYRUN_PEAK_BAND`` of the dry run's tracked peak of the same cell
   (``python -m repro_torch.launch.dryrun`` on (16, 16), started with
   phase 24's CLI cells and run beside the LM phases), its wall, its
   collectives by purpose (the region sums, the vocab-parallel MAX and
   SUM, the gradients' reductions), and ``hand_count``'s products
   and peak parts beside the dry run's; (b) phase 23's NCCL world of 1
   runs the same code, bit for bit the unsharded step (asserted there);
26. MLA heads and MoE experts over "model" (run after 25, ROADMAP item
   14g): (a) one real train step of deepseek-v2-lite-16b at full width
   and full depth (27 layers) on ``TP_ROWS`` × 4 096 tokens of
   train_4k, bf16, as rank 0 of a fake world of 256 ranks on (16, 16),
   as phase 25(a): its ``max_memory_allocated`` under ``TP_LIMIT_GB``
   and within ``DRYRUN_PEAK_BAND`` of the dry run's tracked peak of the
   same cell, its wall, its collectives by purpose (MLA's region sums,
   the routed and shared experts' sums, the gradients' reductions) and
   ``hand_count``'s products and peak parts; (b) one decode_32k step
   of the same model as rank 0 of (16, 16) on the rank's rows of zero
   caches, the MLA latent caches cut over positions, one token into the
   last slot: ``max_memory_allocated`` within the band of that cell's
   dry run, its collectives (q gathered, the softmax's MAX and SUM over
   "model"). Both dry runs (``python -m repro_torch.launch.dryrun``)
   start with phase 24's CLI cells and run beside the LM phases;
27. Mamba2 heads over "model" and the recurrent caches in the
   reference's layouts (run after 26): (a) one real
   train step of zamba2-1.2b at full width and full depth (38 Mamba2
   blocks, 6 applications of the shared block) on ``TP_ROWS`` × 4 096
   tokens of train_4k, bf16, as rank 0 of a fake world of 256 ranks on
   (16, 16), as phase 25(a): its ``max_memory_allocated`` under
   ``TP_LIMIT_GB`` and within ``DRYRUN_PEAK_BAND`` of the dry run's
   tracked peak of the same cell, its wall, its collectives by purpose
   (the Mamba2 region's sums, the gated norms' summed squares, the
   shared block's region, the gradients' reductions) and
   ``hand_count``'s products and peak parts; (b) one decode_32k step of
   the same model on the rank's rows of zero caches, ``ssm`` cut over
   heads and ``conv`` over channels (gathered and cut again around the
   step: ``state``): ``max_memory_allocated`` within the band of that
   cell's dry run. Both dry runs start with phase 24's CLI cells; the
   phase prints its seconds beside those that phase 22's cut of zamba2's
   steps (from ``LM_STEPS`` to ``LM_STEPS - 1``) saved;
15. summary: one JSON line of per-kernel numbers (with, for
   ``screen_matvec``, ``fista_step`` and ``cd_gram_sweep``, the batched
   path's launches and its B = 8 row at its own shapes, for
   ``screen_matvec`` the stacked rows, and for every kernel the serve,
   solve and rules phases' launches; and a ``screen_matvec_bf16`` row:
   the bf16 instantiation's launches on phase 14's bf16 EDPP path and
   its times at 784 × 50 000 for 1, 8 and 16 rows and at 3072 × 99 288,
   beside its byte bound at 2 bytes an element of X and
   ``torch.matmul(c.bfloat16(), X̂)``; and a ``fista_step_bf16`` row: its
   launches on phase 16's bf16-solve EDPP path and its phase-3 rows;
   every row with phase 17's mesh launches and phase 18's update
   launches, ``edpp_screen_scores`` and ``group_screen_scores`` with
   their wide-plan rows, and phase 19's group mesh and one-shot
   launches; ``group_screen_scores`` also with phase 20's bridge
   launches and its m = 1 row), then
   the card's name and power limit, then, last,
   ``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --kernels [--tree DIR]`` runs phases 1 to 3 only
and prints their rows as one JSON line; with ``--tree`` it imports the
package (and builds the kernels) of the checkout at DIR instead of this
one, so that two trees are timed in one call by the same code (the
plans, registers and cluster comparison print only where that tree has
them).

``python3 chip_smoke.py --faults`` runs phases 1 and 2 and then the
mutation check of phases 6, 8 and 9's ``dist_fista`` check: the sound arm
and arms whose kernel output is faulted on purpose (``FAULTS``), with
each check's readings and verdict; every faulted arm whose β the fault
moves must fail.

``python3 chip_smoke.py --lm-lr`` runs phase 1 and then phase 20(a)'s
train steps alone at each of ``LM_LR_SWEEP``'s rates, twice the phase's
steps on its fixed batch each, and prints each rate's losses and whether
they fell at every step: the reading ``LM_LR`` was chosen from.

``python3 chip_smoke.py --moe`` runs phase 1 and then phase 21 alone;
``--ssm`` phase 1 and then phase 22 alone; ``--shard`` phase 1 and then
phase 23 alone; ``--dryrun`` phase 1 and then phase 24 alone; ``--tp``
phase 1 and then phase 25(a) alone; ``--ep`` phase 1 and then phase 26
alone; ``--ssm-tp`` phase 1 and then phase 27 alone.

Each path phase sets every launch counter to 0 just before it and reads
them just after: each kernel the path runs must have launched, and no
plain version may have been called.

Any failed phase raises and the script exits non-zero. It also exits
non-zero, printing no result, without a CUDA device or outside a checkout
of the repository (it imports the package from ``src/``).
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# the kernels' cost rules and the H100 SXM rates they read
# (src/repro_torch/kernels/cost.py): load_cost_rules() binds them here
HBM_BYTES_PER_S = F32_FLOPS_PER_S = None
bound = cd_bound = prox_bound = group_bound = None
REPS = 20
RUN = 4          # back-to-back launches timed together (cluster_choice)
GRAPH_RUN = 25   # calls per timed run or graph (prox step, dist_fista pieces)
PARTS = 4        # dist_fista's n_chunks: the gradient parts prox_step sums
MNIST = (784, 50000)
SVHN = (3072, 99288)
GROUP_FULL = (250, 200000, 10)     # bench_group.py --full, n_g = 20 000
GROUP_EXACT = (250, 20000, 10)     # a tenth of the width, n_g = 2 000
CD_SWEEPS = 10
# The exactness phases' limits on max|Δβ|, relative to the largest entry
# of the path they are held against (PERF.md §6, PR 12: the readings of
# sound and faulted arms, ``--faults``, that they were set from)
CD_REL_TOL = 1e-4
GROUP_REL_TOL = 1e-2
# dist_fista: "chunked" against "none", max|Δβ| relative to max|β_none|
FISTA_REL_TOL = 1e-4
FISTA_ITERS = 500
POWER_ITERS = 30
REPLACES = {
    "edpp_screen_scores": "src/repro/kernels/edpp_screen.py:140",
    "screen_matvec": "src/repro/kernels/edpp_screen.py:202",
    "fista_step": "src/repro/kernels/solver_step.py:146",
    "cd_gram_sweep": "src/repro/kernels/solver_step.py:251",
    "group_screen_scores": "src/repro/kernels/group_screen.py:68",
    "prox_step": "src/repro/kernels/prox_step.py:67",
}
SOURCES = {
    "edpp_screen_scores": "src/repro_torch/kernels/csrc/edpp_screen.cu",
    "screen_matvec": "src/repro_torch/kernels/csrc/edpp_screen.cu",
    "fista_step": "src/repro_torch/kernels/csrc/solver_step.cu",
    "cd_gram_sweep": "src/repro_torch/kernels/csrc/cd_gram.cu",
    "group_screen_scores": "src/repro_torch/kernels/csrc/group_screen.cu",
    "prox_step": "src/repro_torch/kernels/csrc/prox_step.cu",
}


T_START = time.perf_counter()


@contextlib.contextmanager
def phase(name: str):
    """A phase's header and seconds on stdout; the same two lines, with the
    seconds since the script started, on stderr, whose tail then says which
    phase a run that was stopped had reached."""
    t0 = time.perf_counter()
    print(f"== {name}", flush=True)
    print(f"[{t0 - T_START:.1f} s] start: {name}", file=sys.stderr,
          flush=True)
    yield
    t1 = time.perf_counter()
    print(f"== {name}: {t1 - t0:.2f} s", flush=True)
    print(f"[{t1 - T_START:.1f} s] end: {name} ({t1 - t0:.2f} s)",
          file=sys.stderr, flush=True)


def make_dataset(n: int, p: int, seed: int = 0):
    """benchmarks/bench_sequential.make_dataset: Gaussian X, a 16-sparse
    Gaussian truth, noise 0.05."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    w = np.zeros(p)
    idx = rng.choice(p, 16, replace=False)
    w[idx] = rng.standard_normal(idx.size)
    y = X @ w + 0.05 * rng.standard_normal(n)
    return X.astype(np.float32), y.astype(np.float32)


def beta_err_tol(y, solver_tol: float, kappa: float = 25.0) -> float:
    """benchmarks/common.beta_err_tol: the gap between two paths that each
    stop at relative duality gap ``solver_tol``."""
    scale = 0.5 * float(np.asarray(y, np.float64) @ np.asarray(y, np.float64))
    return kappa * float(np.sqrt(solver_tol * scale))


def event_ms(torch, fn, reps: int = REPS) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events. A
    sleep kernel ahead of each run keeps the stream busy while the host
    enqueues it, so the interval holds device work only, not Python
    launch time."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def run_ms(torch, fn, k: int) -> float:
    """ms per call of ``fn`` in a run of ``k`` back-to-back calls launched
    from Python (what an eager loop pays), by :func:`event_ms`."""
    return event_ms(torch, lambda: [fn() for _ in range(k)]) / k


def graph_ms(torch, fn, k: int) -> float:
    """ms per call of ``fn`` replayed from a CUDA graph of ``k``
    back-to-back calls (one warm-up call on a side stream, then one
    capture), by :func:`event_ms` on the replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    return event_ms(torch, graph.replay) / k


def load_cost_rules() -> None:
    """Bind the kernels' cost rules (``bound``, ``cd_bound``,
    ``prox_bound``, ``group_bound``) and the card's rates from this
    checkout's ``src/repro_torch/kernels/cost.py``, loaded by its path:
    ``--kernels --tree DIR`` times another tree's kernels against the
    same bounds, and the dry run (phase 24) charges a fake launch by the
    same rules."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_kernel_cost",
        os.path.join(HERE, "src", "repro_torch", "kernels", "cost.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    g = globals()
    g.update(HBM_BYTES_PER_S=mod.H100_HBM_BYTES_PER_S,
             F32_FLOPS_PER_S=mod.H100_F32_FLOPS_PER_S, bound=mod.bound,
             cd_bound=mod.cd_bound, prox_bound=mod.prox_bound,
             group_bound=mod.group_bound)


# The column pass's MODE template argument per op (csrc/colpass.cuh)
COLPASS_MODE = {"screen_matvec": 0, "edpp_screen_scores": 1, "fista_step": 2,
                "group_screen_scores": 3}
CHAIN_TURNS = 4096   # turns of 32 steps the chain kernel runs per launch


def chain_step_ns(torch, kernels) -> float | None:
    """The latency of one dependent coordinate step of the Gram sweep: the
    one-warp ``cd_chain_f32`` kernel of ``csrc/cd_gram.cu`` runs
    CHAIN_TURNS turns of 32 steps (the sweep's own ``turn``: the update,
    the IEEE division, the shuffle broadcast, the rank-1 update of q) on
    values in registers, timed by CUDA events (median of 5). None for a
    tree without that kernel."""
    try:
        fn = kernels.edpp_screen.kernel_fn("cd_gram", "cd_chain_f32")
    except (AttributeError, KeyError):
        return None
    out = torch.empty(32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(CHAIN_TURNS, 32, 0.1, 2.0, out.data_ptr(), stream)
        assert err == 0, f"cd_chain_f32: cudaError_t {err}"
    ms = event_ms(torch, run, reps=5)
    assert bool(torch.isfinite(out).all())
    return ms * 1e6 / (CHAIN_TURNS * 32)


def ptxas_table(logs: dict[str, str]) -> dict[str, tuple[int, int, int]]:
    """Registers and spill bytes (stores, loads) of every kernel in the
    build's ``-Xptxas -v`` logs, by mangled name."""
    table, fn, spills = {}, None, (0, 0)
    for log in logs.values():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn, spills = m.group(1), (0, 0)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                table[fn] = (int(m.group(1)), *spills)
    return table


def kernel_ptxas(table: dict, key: str) -> str:
    """The registers and spills of the kernel whose mangled name holds
    ``key``."""
    hits = [v for k, v in table.items() if key in k]
    if not hits:
        return "ptxas n/a (libraries not rebuilt here)"
    regs, st, ld = hits[0]
    return f"{regs} registers, spills {st}/{ld} bytes (stores/loads)"


def colpass_ptxas(table: dict, op: str, nb: int, vec: int,
                  bf16: bool = False) -> str:
    """The registers and spills of the column-pass instantiation that a
    launch of ``op`` with ``nb`` queries and loads of width ``vec`` runs,
    on float32 or bf16 X (the template's last argument)."""
    elem = "13__nv_bfloat16" if bf16 else "f"
    return kernel_ptxas(table, f"colpass_kernelILi{COLPASS_MODE[op]}ELi{nb}"
                               f"ELb{int(vec > 1)}E{elem}E")


def plan_line(kernels, X, B: int, op: str, ptxas: dict,
              wide_p: int | None = None) -> str:
    """The launch plan of a column-pass kernel on X for B queries (with
    ``wide_p``: the plan of a block of a ``wide_p``-column pass), with the
    registers and spills of the kernel it runs; 'n/a' for a tree whose
    wrappers choose no plan."""
    plan_for = getattr(kernels.edpp_screen, "plan_for", None)
    if plan_for is None:
        return "plan n/a"
    pl = plan_for(X, min(B, kernels.edpp_screen.MAX_B), wide_p)
    ptx = colpass_ptxas(ptxas, op, min(B, 8), pl.vec, X.element_size() == 2)
    return (f"plan grid={pl.grid} block={pl.block} cluster={pl.split} "
            f"vec={pl.vec} tile={pl.tile} stage_rows={pl.stage_rows} "
            f"smem={pl.smem} B; {ptx}")


def check_cd(torch, kernels, ref, p: int, B: int, seed: int,
             masked: bool = False, step_ns: float | None = None,
             ptxas: dict | None = None) -> dict:
    """The Gram CD sweep (CD_SWEEPS sweeps) against its plain version:
    the reference's case, G = AᵀA with three zero columns, c = 0.1·rG,
    a small warm start, λ = ½·max|c| per query. Tolerance, elementwise:
    2e-5 + 2e-4·|plain| (the reference's own for this sweep: a rounding
    difference in q₀ propagates along the chain). Beside the byte/flop
    bound, the chain bound: CD_SWEEPS·p steps × ``step_ns``, the
    latency of one step (``chain_step_ns``), with the registers and
    spills of the kernel the launch runs."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    A = torch.randn(2 * p, p, generator=g, device="cuda")
    A[:, -3:] = 0.0
    G = A.T @ A
    G = 0.5 * (G + G.T)                  # exactly symmetric
    lead = () if B == 1 else (B,)
    c = 0.1 * (torch.randn(*lead, p, generator=g, device="cuda") @ G)
    beta = 0.1 * torch.randn(*lead, p, generator=g, device="cuda")
    valid = None
    if masked:
        valid = (torch.rand(*lead, p, generator=g, device="cuda")
                 > 0.3).float()
        beta = beta * valid
    lam = 0.5 * c.abs().amax(-1) if B > 1 else 0.5 * float(c.abs().max())
    args = (G, c, beta, lam, CD_SWEEPS, valid)
    out_k = kernels.cd_gram_sweep(*args)
    out_p = ref.cd_gram_sweep_ref(*args)
    torch.cuda.synchronize()
    assert out_k.shape == out_p.shape and bool(torch.isfinite(out_k).all())
    err = float((out_k - out_p).abs().max())
    excess = float(((out_k - out_p).abs() - 2e-4 * out_p.abs()).max())
    ok = excess <= 2e-5 and not out_k[..., -3:].any() and (
        valid is None or not (out_k * (1 - valid)).any())
    ms = event_ms(torch, lambda: kernels.cd_gram_sweep(*args))
    plain_ms = event_ms(torch, lambda: ref.cd_gram_sweep_ref(*args), reps=3)
    bound_ms, bound_by = cd_bound(p, B, CD_SWEEPS, masked)
    steps = CD_SWEEPS * p
    chain_ms = None if step_ns is None else steps * step_ns * 1e-6
    which = "cd_warp_kernel" if p <= 32 else "cd_block_kernel"
    regs = kernel_ptxas(ptxas or {}, which)
    row = {"op": "cd_gram_sweep", "p": p, "B": B, "valid": masked,
           "max_abs_err": err, "tol": "2e-5 + 2e-4*|plain|", "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "chain_steps": steps, "ns_per_step": ms * 1e6 / steps,
           "chain_ms": chain_ms, "ptxas": f"{which}: {regs}"}
    chain = ("chain bound n/a" if chain_ms is None else
             f"chain bound {chain_ms:.4f} ms ({step_ns:.1f} ns/step), "
             f"kernel {ms / chain_ms:.2f}x it")
    print(f"  cd_gram_sweep       p={p} B={B} valid={masked} sweeps="
          f"{CD_SWEEPS}: max_abs_err={err:.3g} (2e-5 + 2e-4·|plain|) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.6f} "
          f"({bound_by}); chain of {steps} steps, "
          f"{row['ns_per_step']:.1f} ns/step; {chain}\n      "
          f"{row['ptxas']}", flush=True)
    if not ok:
        raise AssertionError(f"cd_gram_sweep p={p} B={B}: kernel disagrees "
                             f"with its plain version (excess {excess})")
    return row


def group_plan_line(kernels, X, m: int, ptxas: dict) -> str:
    """The group pass's launch plan on X with the registers and spills of
    the kernel it runs; 'n/a' for a tree without a group plan."""
    plan_for = getattr(kernels.group_screen, "group_plan_for", None)
    if plan_for is None:
        return "plan n/a"
    pl = plan_for(X, m)
    return (f"plan grid={pl.grid} block={pl.block} cluster={pl.split} "
            f"vec={pl.vec} tile={pl.tile} steps={-(-pl.tile // 128)} "
            f"stage_rows={pl.stage_rows} smem={pl.smem} B; "
            f"{colpass_ptxas(ptxas, 'group_screen_scores', 1, pl.vec)}")


def check_group(torch, kernels, ref, n: int, p: int, m: int,
                seed: int, ptxas: dict | None = None) -> dict:
    """The group scores against their plain version; tolerance
    2e-5·max(1, max|plain|) (sums run in another order). Bound: the bytes
    of X (2 flops per element); yardstick c @ X, which computes the dots
    but not the group norms."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(n, p, generator=g, device="cuda")
    c = torch.randn(n, generator=g, device="cuda")
    out_k = kernels.group_screen_scores(X, c, m)
    out_p = ref.group_screen_ref(X, c, m)
    torch.cuda.synchronize()
    assert out_k.shape == out_p.shape == (p // m,)
    assert bool(torch.isfinite(out_k).all())
    err = float((out_k - out_p).abs().max())
    tol = 2e-5 * max(1.0, float(out_p.abs().max()))
    ms = event_ms(torch, lambda: kernels.group_screen_scores(X, c, m))
    plain_ms = event_ms(torch, lambda: ref.group_screen_ref(X, c, m))
    matmul_ms = event_ms(torch, lambda: torch.matmul(c, X))
    bound_ms, bound_by = group_bound(n, p, m)
    plan = group_plan_line(kernels, X, m, ptxas or {})
    row = {"op": "group_screen_scores", "n": n, "p": p, "m": m,
           "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
           "matmul_ms": matmul_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "of_bound": bound_ms / ms, "matmul_ratio": ms / matmul_ms,
           "plan": plan}
    print(f"  group_screen_scores {n}x{p} m={m}: max_abs_err={err:.3g} "
          f"(tol {tol:.3g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"matmul_ms={matmul_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
          f"{bound_ms / ms:.0%} of bound, {ms / matmul_ms:.2f}x torch.matmul"
          f"\n      {plan}", flush=True)
    if not err <= tol:
        raise AssertionError(f"group_screen_scores {n}x{p} m={m}: kernel "
                             f"disagrees with its plain version: {err}")
    del X, c
    torch.cuda.empty_cache()
    return row


def check_prox(torch, prox_step, ref, p: int, B: int, per_query: bool,
               seed: int, floors: dict, parts: int | None = None) -> dict:
    """The prox step against its plain version, timed alone, per launch
    in a run of GRAPH_RUN launches from Python and per launch replayed
    from a CUDA graph of GRAPH_RUN launches, beside the launch floors of
    the same kinds (``floors``). Bound: :func:`prox_bound`.

    With ``parts``, g is a (parts, B, p) stack of gradient parts and the
    parameters a (3, B) device block (the distributed FISTA's
    ``"chunked"`` call): bit for bit the plain version (the parts summed
    in index order, then the prox), with ``torch.sum`` over the parts
    beside it (the parts' sum alone: no library call computes the prox).
    Without, g is plain and the parameters host numbers or (B,) tensors:
    both round each product and difference alone, so they agree but for
    the threshold step·λ, which the plain version's scalar path rounds
    from host numbers: tolerance 1e-6·max(1, max|plain|); no library
    call computes it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if B == 1 else (B,)
    z, b = (torch.randn(*lead, p, generator=g, device="cuda")
            for _ in range(2))
    if parts:
        stack = torch.randn(parts, *lead, p, generator=g, device="cuda")
        par = torch.stack([torch.full((B,), 1.0 / 65000, device="cuda"),
                           300.0 * torch.rand(B, generator=g, device="cuda"),
                           torch.rand(B, generator=g, device="cuda")])
        args, kw = (z, stack, b), {"params": par}
    else:
        grad = torch.randn(*lead, p, generator=g, device="cuda")
        if per_query:
            par = tuple(torch.rand(B, generator=g, device="cuda")
                        for _ in range(3))
        else:
            par = (1.0 / 65000, 300.0, 0.6)
        args, kw = (z, grad, b, *par), {}
    out_k, out_p = prox_step(*args, **kw), ref.prox_step_ref(*args, **kw)
    torch.cuda.synchronize()
    err, tol = 0.0, 0.0
    for a, w in zip(out_k, out_p):
        assert a.shape == w.shape == z.shape and bool(torch.isfinite(a).all())
        err = max(err, float((a - w).abs().max()))
        tol = max(tol, 0.0 if parts else 1e-6 * max(1.0, float(
            w.abs().max())))
    ms = event_ms(torch, lambda: prox_step(*args, **kw))
    in_run = run_ms(torch, lambda: prox_step(*args, **kw), GRAPH_RUN)
    in_graph = graph_ms(torch, lambda: prox_step(*args, **kw), GRAPH_RUN)
    plain_ms = event_ms(torch, lambda: ref.prox_step_ref(*args, **kw))
    library_ms = event_ms(torch, lambda: torch.sum(stack, 0)) if parts \
        else None
    bound_ms, bound_by = prox_bound(p, B, parts or 1)
    row = {"op": "prox_step", "p": p, "B": B, "per_query": per_query,
           "parts": parts, "max_abs_err": err, "tol": tol, "ms": ms,
           "run_ms": in_run, "graph_ms": in_graph, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms, "floors": floors}
    library = ("none: no single call" if library_ms is None else
               f"{library_ms:.4f} (torch.sum over the parts)")
    print(f"  prox_step {parts or 'no'} parts p={p} B={B} per_query="
          f"{per_query}: max_abs_err={err:.3g} (tol {tol:.3g}) "
          f"ms={ms:.4f} per launch in a run of {GRAPH_RUN} "
          f"{in_run:.4f} (zero_ {floors['run']:.4f}), in a graph "
          f"{in_graph:.4f} (zero_ {floors['graph']:.4f}) plain_ms="
          f"{plain_ms:.4f} bound_ms={bound_ms:.6f} ({bound_by}); "
          f"library_ms {library}", flush=True)
    if not err <= tol:
        raise AssertionError(f"prox_step {parts} parts p={p} B={B}: kernel "
                             f"disagrees with its plain version: {err} > "
                             f"{tol}")
    return row


@contextlib.contextmanager
def nccl_world(torch, names: tuple[str, ...] = ("query", "feature")):
    """A process group of one rank over NCCL on card 0 (a HashStore: no
    address, no port) and its mesh of ones with axes ``names`` (the
    sessions' ("query", "feature") by default); the group is torn down on
    exit. An NCCL failure fails the phase."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                             world_size=1, device_id=torch.device("cuda", 0))
    try:
        yield init_device_mesh("cuda", (1,) * len(names),
                               mesh_dim_names=names)
    finally:
        tdist.destroy_process_group()


def fista_readings(torch, D, mesh, Xl, yt, lam: float, L: float, beta0,
                   beta_solve) -> dict:
    """What the dist_fista check reads: FISTA_ITERS iterations of "none"
    and "chunked" from beta0, each replayed from CUDA graphs (the default)
    and with ``capture=False`` (keys ``<mode>_eager``); whether the two
    gave the same bits; max|β_chunked − β_none| relative to max|β_none|,
    and each mode's max|Δβ| to the unsharded solve, with the kernel
    launches and seconds of each run."""
    from repro_torch.kernels import ops
    out, betas = {}, {}
    for mode in ("none", "chunked"):
        for key, capture in ((mode, True), (f"{mode}_eager", False)):
            ops.reset_counts()
            t0 = time.perf_counter()
            betas[key] = D.dist_fista(mesh, Xl, yt, lam, beta0, L,
                                      iters=FISTA_ITERS, overlap=mode,
                                      capture=capture)
            torch.cuda.synchronize()
            out[f"{key}_s"] = time.perf_counter() - t0
            out[f"{key}_launches"] = ops.launch_counts()
            assert not any(ops.plain_counts().values()), ops.plain_counts()
    b_n, b_c = betas["none"], betas["chunked"]
    scale = float(b_n.abs().max())
    return dict(out, rel=float((b_c - b_n).abs().max()) / max(scale, 1e-30),
                err_none=float((b_n - beta_solve).abs().max()),
                err_chunked=float((b_c - beta_solve).abs().max()),
                scale=scale, bits_equal={
                    m: torch.equal(betas[m], betas[f"{m}_eager"])
                    for m in ("none", "chunked")})


def fista_failures(r: dict, y) -> list[str]:
    """The dist_fista check: "chunked" within FISTA_REL_TOL·max|β_none| of
    "none", both within beta_err_tol of the unsharded solve, the
    captured runs bit for bit the eager ones, and each run's kernel
    launched once per iteration."""
    fails = []
    if not r["rel"] <= FISTA_REL_TOL:
        fails.append(f"chunked vs none {r['rel']:.3g} > {FISTA_REL_TOL:g}")
    for mode, op in (("none", "fista_step"), ("chunked", "prox_step")):
        if not r[f"err_{mode}"] <= beta_err_tol(y, 1e-6):
            fails.append(f"{mode} vs the solve > beta_err_tol")
        if not r["bits_equal"][mode]:
            fails.append(f"{mode}: captured beta differs from eager")
        for key in (mode, f"{mode}_eager"):
            if r[f"{key}_launches"][op] != FISTA_ITERS:
                fails.append(f"{key}: {op} not once per iteration")
    return fails


def fista_breakdown(torch, D, mesh, Xl, yt) -> dict:
    """ms per iteration of each piece of a dist_fista iteration, each
    replayed from a CUDA graph of GRAPH_RUN repetitions at the path's
    shapes: "none" = the fit X_b z, its n-vector SUM, the fused
    fista_step; "chunked" = the PARTS chunk fits, their PARTS async SUMs
    (with the waits), the PARTS gradient products X_cᵀ(f − y_c) and the
    prox on the stack. The parameters sit in a (3, 1) device block."""
    from repro_torch.kernels import ops
    SUM = torch.distributed.ReduceOp.SUM
    n, p = Xl.shape
    group = D._feature(mesh)[0]
    z = 0.01 * torch.randn(p, generator=torch.Generator(device="cuda")
                           .manual_seed(7), device="cuda")
    par = torch.tensor([[1.0 / 65000], [300.0], [0.6]], device="cuda")
    chunk = -(-n // PARTS)
    bounds = [(lo, min(n, lo + chunk)) for lo in range(0, n, chunk)]
    fits = [Xl[lo:hi] @ z for lo, hi in bounds]
    parts = torch.empty(len(bounds), p, device="cuda")
    r = Xl @ z - yt
    vec = torch.zeros(n, device="cuda")

    def reduce_chunks():
        works = [D._reduce(f, group, SUM, async_op=True)
                 for f in fits]
        for w in works:
            w.wait()

    def products():
        for c, (lo, hi) in enumerate(bounds):
            torch.matmul(Xl[lo:hi].T, fits[c] - yt[lo:hi], out=parts[c])

    pieces = {
        "none": {"fit": lambda: Xl @ z,
                 "sum": lambda: D._reduce(vec, group, SUM),
                 "fista_step": lambda: ops.BACKENDS["cuda"].fista_step(
                     Xl, r, z, z, params=par)},
        "chunked": {"fits": lambda: [Xl[lo:hi] @ z for lo, hi in bounds],
                    "sums": reduce_chunks, "products": products,
                    "prox": lambda: ops.BACKENDS["cuda"].prox_step(
                        z, parts, z, params=par)}}
    out = {mode: {k: graph_ms(torch, fn, GRAPH_RUN) for k, fn in ps.items()}
           for mode, ps in pieces.items()}
    t_bytes = 4.0 * 2 * n * p / HBM_BYTES_PER_S * 1e3
    print(f"  dist_fista pieces, ms per iteration replayed from a graph of "
          f"{GRAPH_RUN} (X read twice an iteration: byte bound "
          f"{t_bytes:.4f} ms): " + "; ".join(
              f"{mode}: " + ", ".join(f"{k} {v:.4f}" for k, v in ps.items())
              + f" (sum {sum(ps.values()):.4f})" for mode, ps in out.items()),
          flush=True)
    return dict(out, bound_ms=t_bytes)


BLOCKS = (1, 5, 10, 25, 50)     # iterations per captured block, swept


def block_sweep(torch, D, mesh, Xl, yt, lam: float, L: float, beta0) -> dict:
    """ms per iteration of FISTA_ITERS captured iterations of "none" and
    "chunked" from beta0 with each block size of BLOCKS (the capture's
    eager prefix, its capture and the replays all inside the wall), each
    run's β bit for bit the eager run's."""
    from repro_torch.core import graphs
    out = {}
    for mode in ("none", "chunked"):
        want = D.dist_fista(mesh, Xl, yt, lam, beta0, L, iters=FISTA_ITERS,
                            overlap=mode, capture=False)
        out[mode] = {}
        for k in BLOCKS:
            graphs.BLOCK, default = k, graphs.BLOCK
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                beta = D.dist_fista(mesh, Xl, yt, lam, beta0, L,
                                    iters=FISTA_ITERS, overlap=mode)
                torch.cuda.synchronize()
                out[mode][k] = (time.perf_counter() - t0) / FISTA_ITERS * 1e3
            finally:
                graphs.BLOCK = default
            assert torch.equal(beta, want), (mode, k)
    print(f"  dist_fista ms per iteration by block size {BLOCKS} (default "
          f"{graphs.BLOCK}), captured bits equal to eager at each: "
          + "; ".join(f"{mode} " + ", ".join(f"{k}: {v:.4f}"
                                             for k, v in ms.items())
                      for mode, ms in out.items()), flush=True)
    return out


def fista_problem(torch, D, mesh, X, y):
    """The dist_fista check's set-up on the mesh: X's block and y, L =
    1.05 × the power iteration, λ = 0.3·λ_max (``lambda_max_d``), the
    unsharded FISTA solve at tol 1e-8 on the whole X, and the two starts
    (β = 0; a dense 0.01·N(0, 1) from a CPU generator seeded 0)."""
    from repro_torch.core import SolverEngine
    Xl, yt = D.shard_problem(mesh, X, y)
    L = 1.05 * float(D.dist_power_iteration(mesh, Xl, POWER_ITERS))
    lam = 0.3 * float(D.make_dist_ops(mesh)[0](Xl, yt))
    solve = SolverEngine(yt, tol=1e-8).solve(Xl, lam)
    p = X.shape[1]
    dense = 0.01 * torch.randn(p, generator=torch.Generator().manual_seed(0))
    starts = {"zero": torch.zeros(p, device=Xl.device),
              "dense": D.place_features(mesh, dense)}
    return Xl, yt, L, lam, solve.beta, starts


def counted(ops, needed: tuple[str, ...]) -> dict:
    """The launch counts read just after a path (set to 0 just before it):
    every kernel in ``needed`` launched, no plain version was called."""
    launches, plain = ops.launch_counts(), ops.plain_counts()
    print(f"launches {launches} plain-version calls {plain}")
    assert all(launches.get(k, 0) > 0 for k in needed), (needed, launches)
    assert not any(plain.values()), plain
    return launches


def deciles(res, units: int) -> str:
    """The mean discard fraction over each tenth of the grid."""
    frac = [s.n_discarded / units for s in res.stats]
    step = max(1, len(frac) // 10)
    return " ".join(f"{np.mean(frac[k:k + step]):.4f}"
                    for k in range(0, len(frac), step))


def cd_readings(res_cd, res_fi, max_epochs: int) -> dict:
    """What the CD exactness check reads: whether every solve converged,
    the steps that ran out of epochs, max|β_cd − β_fista| and, beside it,
    max|β_fista|."""
    live = [s for s in res_cd.stats if s.screen_backend]
    return {"converged": bool(res_cd.query_converged[0]),
            "at_max_epochs": sum(s.solver_iters >= max_epochs for s in live),
            "err": float(np.abs(res_cd.betas - res_fi.betas).max()),
            "scale": float(np.abs(res_fi.betas).max())}


def cd_failures(r: dict, y) -> list[str]:
    """The CD path's check: every solve converged (none at max_epochs),
    and β within beta_err_tol and within CD_REL_TOL·max|β_fista| of the
    FISTA path."""
    fails = []
    if not r["converged"]:
        fails.append("a solve stopped above tol")
    if r["at_max_epochs"]:
        fails.append(f"{r['at_max_epochs']} steps at max_epochs")
    if r["err"] > beta_err_tol(y, 1e-6):
        fails.append("max|dbeta| > beta_err_tol")
    if r["err"] > CD_REL_TOL * r["scale"]:
        fails.append(f"max|dbeta| > {CD_REL_TOL:g}*max|beta_fista|")
    return fails


def group_readings(res, res_none, m: int) -> dict:
    """What the group exactness check reads against the unscreened arm:
    max|Δβ| beside max|β_none|, the discarded groups that the unscreened
    solution needs (norm above 1e-6·max|β_none|), the discard fraction
    and the KKT rounds."""
    b_n = res_none.betas[0]
    needed = (np.linalg.norm(b_n.reshape(b_n.shape[0], -1, m), axis=2)
              > 1e-6 * np.abs(b_n).max())
    return {"err": float(np.abs(res.betas[0] - b_n).max()),
            "scale": float(np.abs(b_n).max()),
            "unsafe": int((res.masks[0] & needed).sum()),
            "discard": float(res.masks[0].mean()),
            "kkt_rounds": sum(s.kkt_rounds for s in res.stats)}


def group_failures(r: dict, y) -> list[str]:
    """The group path's check: no unsafe group discard, and β within
    beta_err_tol and within GROUP_REL_TOL·max|β_none| of the unscreened
    arm."""
    fails = []
    if r["unsafe"]:
        fails.append(f"{r['unsafe']} unsafe group discards")
    if r["err"] > beta_err_tol(y, 1e-6):
        fails.append("max|dbeta| > beta_err_tol")
    if r["err"] > GROUP_REL_TOL * r["scale"]:
        fails.append(f"max|dbeta| > {GROUP_REL_TOL:g}*max|beta_none|")
    return fails


# Faults for the mutation check (``--faults``): each wraps the real kernel
# on the cuda backend the way a kernel bug would change its output.
def _cd_lam_high(real):
    """λ read 1 % high (another query's λ, say)."""
    return lambda G, c, beta, lam, sweeps=1, valid=None: real(
        G, c, beta, lam * 1.01, sweeps, valid)


def _cd_first_frozen(real):
    """The bucket's first coordinate never updated (an off-by-one in the
    coordinate loop)."""
    def sweep(G, c, beta, lam, sweeps=1, valid=None):
        out = real(G, c, beta, lam, sweeps, valid)
        out[..., 0] = beta[..., 0]
        return out
    return sweep


def _cd_bf16_gram(real):
    """G read at bfloat16 precision."""
    return lambda G, c, beta, lam, sweeps=1, valid=None: real(
        G.bfloat16().float(), c, beta, lam, sweeps, valid)


def _group_scaled(factor):
    """Every group score scaled by ``factor`` (a square left out of the
    sum, say)."""
    return lambda real: lambda X, c, m: factor * real(X, c, m)


def _group_shifted(real):
    """Group g's score written to g + 1 (an off-by-one in the output)."""
    return lambda X, c, m: real(X, c, m).roll(1)


def _prox_threshold_high(real):
    """The threshold step·λ 1 % high (λ read from the wrong query, say)."""
    def prox(z, g, b, step=None, lam=None, mom=None, *, params=None):
        if params is not None:
            params = params.clone()
            params[1] *= 1.01
        else:
            lam = lam * 1.01
        return real(z, g, b, step, lam, mom, params=params)
    return prox


def _prox_tail_unwritten(real):
    """The last 1 % of columns left unwritten (a grid that stops short):
    β' and z' keep β_old and z there."""
    def prox(z, g, b, *args, **kw):
        bn, zn = real(z, g, b, *args, **kw)
        k = max(1, z.shape[-1] // 100)
        bn[..., -k:] = b[..., -k:]
        zn[..., -k:] = z[..., -k:]
        return bn, zn
    return prox


FAULTS = {
    "cd_gram_sweep": (("lambda 1% high", _cd_lam_high),
                      ("first coordinate frozen", _cd_first_frozen),
                      ("G read at bf16", _cd_bf16_gram)),
    "group_scores": (("scores 5% low", _group_scaled(0.95)),
                     ("scores 20% low", _group_scaled(0.8)),
                     ("score of g written to g+1", _group_shifted)),
    "prox_step": (("threshold step*lambda 1% high", _prox_threshold_high),
                  ("last 1% of columns unwritten", _prox_tail_unwritten)),
}


@contextlib.contextmanager
def faulted(ops, field: str, make):
    """The cuda backend with ``field`` wrapped by ``make`` (none: sound)."""
    sound = ops.BACKENDS["cuda"]
    if make is not None:
        ops.BACKENDS["cuda"] = sound._replace(
            **{field: make(getattr(sound, field))})
    try:
        yield
    finally:
        ops.BACKENDS["cuda"] = sound


def fault_check(torch) -> list[dict]:
    """The mutation check of the CD and group exactness phases and of the
    dist_fista check: the sound arm and each fault of FAULTS run the
    check as the smoke run does, and their readings and failures are
    printed. Sound arms must pass, and every faulted arm that the fault
    harmed must fail its check: harmed means a solve that did not
    converge, a needed group discarded, or max|Δβ| (for dist_fista:
    chunked against none) over ten times the sound arm's. A fault may
    leave β as it was (a screen with room to spare; the KKT rounds behind
    group strong; a prox fault in columns that stay 0)."""
    from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
    from repro_torch.core import distributed as D
    from repro_torch.data import group_lasso_problem
    from repro_torch.kernels import ops

    arms = []

    def record(kind, fault, rule, run, readings, failures):
        try:
            r = readings(run())
            r["failures"] = failures(r)
        except Exception as e:          # a raise is a detection too
            r = {"failures": [f"raised {type(e).__name__}: {e}"]}
        r.update(kind=kind, fault=fault, rule=rule)
        print(f"  {kind} {rule} [{fault}]: {r}", flush=True)
        arms.append(r)

    X, y = make_dataset(*MNIST)
    with nccl_world(torch) as mesh:
        Xl, yt, L, lam, beta_solve, starts = fista_problem(torch, D, mesh, X,
                                                           y)
        for fault, make in (("sound", None), *FAULTS["prox_step"]):
            with faulted(ops, "prox_step", make):
                for start, beta0 in starts.items():
                    record("dist_fista", fault, start,
                           lambda: fista_readings(torch, D, mesh, Xl, yt,
                                                  lam, L, beta0, beta_solve),
                           lambda r: {k: v for k, v in r.items()},
                           lambda r: fista_failures(r, y))
        del Xl, yt, beta_solve, starts
    cd_cfg = PathConfig(solve=SolveSpec(strategy="cd", tol=1e-6))
    max_epochs = cd_cfg.solve.max_iter // 10 + 1
    res_fi = LassoSession.fit(X).path(y, num_lambdas=100, config=PathConfig(
        solve=SolveSpec(tol=1e-6)))
    for fault, make in (("sound", None), *FAULTS["cd_gram_sweep"]):
        with faulted(ops, "cd_gram_sweep", make):
            record("cd", fault, "edpp",
                   lambda: LassoSession.fit(X, config=cd_cfg).path(
                       y, num_lambdas=100),
                   lambda res: cd_readings(res, res_fi, max_epochs),
                   lambda r: cd_failures(r, y))

    n_e, p_e, m = GROUP_EXACT
    X, y, _ = group_lasso_problem(n_e, p_e, m, active_groups=20, seed=0,
                                  dtype=np.float32)
    solve = SolveSpec(tol=1e-6)
    res_none = LassoSession.fit(X, groups=m).path(
        y, num_lambdas=20, hi_frac=0.95,
        config=PathConfig(screen=ScreenSpec(rule="none"), solve=solve))
    grid = res_none.lambdas[0]
    for fault, make in (("sound", None), *FAULTS["group_scores"]):
        with faulted(ops, "group_scores", make):
            sess = LassoSession.fit(X, groups=m)
            for rule in ("edpp", "strong"):
                record("group", fault, rule,
                       lambda: sess.path(y, grid, config=PathConfig(
                           screen=ScreenSpec(rule=rule), solve=solve)),
                       lambda res: group_readings(res, res_none, m),
                       lambda r: group_failures(r, y))
    sound = {(r["kind"], r["rule"]): r for r in arms if r["fault"] == "sound"}
    for r in arms:
        s = sound[r["kind"], r["rule"]]
        key = "rel" if r["kind"] == "dist_fista" else "err"
        r["harmed"] = key not in r or (
            not r.get("converged", True) or r.get("unsafe", 0) > 0
            or r[key] > 10.0 * s[key])
    print(json.dumps({"faults": arms}), flush=True)
    for r in arms:
        if r["fault"] == "sound":
            assert not r["failures"], r
        elif r["harmed"]:
            assert r["failures"], f"fault not caught: {r}"
    return arms


def check_kernel(torch, kernels, ref, op: str, n: int, p: int, B: int,
                 seed: int, floor_ms: float, ptxas: dict,
                 block: bool = False, bf16: bool = False,
                 wide_p: int | None = None) -> dict:
    """One case: the kernel against its plain version on the same inputs,
    then their times, the bound and the c @ X yardstick, with the launch
    plan and, for fista_step, the launch floor beside it. ``block``:
    fista_step takes its step | λ | mom as a ready (3, B) device block
    (``params=``), as the batched solver passes them, instead of a (B,)
    λ the wrapper stacks into one per call. ``bf16``: screen_matvec or
    fista_step on a bf16 copy X̂ (their launches counted as
    ``screen_matvec_bf16`` / ``fista_step_bf16``; the yardstick
    ``torch.matmul(c.bfloat16(), X̂)``); for fista_step with B > 1 each
    row must also be the bits of its query launched alone. ``wide_p``:
    edpp_screen_scores launched with the plan of a pass over ``wide_p``
    columns (an update's added block)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    X = rand(n, p)
    if bf16:
        X = X.to(torch.bfloat16)
    lead = () if B == 1 else (B,)
    c = rand(*lead, n)
    if op == "fista_step":
        z, bo = rand(*lead, p), rand(*lead, p)
        lam = torch.rand(B, generator=g, device="cuda") if B > 1 else 0.7
        step = 1.0 / (n + p)
        args = (X, c, z, bo, step, lam, 0.6)
        kern, plain = kernels.fista_step, ref.fista_step_ref
        if block:
            par = torch.stack([torch.full((B,), step, device="cuda"), lam,
                               torch.full((B,), 0.6, device="cuda")])
            args = (X, c, z, bo)
            kern = functools.partial(kernels.fista_step, params=par)
            plain = functools.partial(ref.fista_step_ref, params=par)
    elif op == "edpp_screen_scores":
        rho = torch.rand(B, generator=g, device="cuda") if B > 1 else 0.37
        args = (X, c, rho)
        kern, plain = kernels.edpp_screen_scores, ref.edpp_screen_ref
        if wide_p is not None:
            kern = functools.partial(kern, wide_p=wide_p)
    else:
        args = (X, c)
        kern, plain = kernels.screen_matvec, ref.screen_matvec_ref
    key = f"{op}_bf16" if bf16 else op
    before = kernels.ops.launch_counts().get(key, 0)
    out_k = kern(*args)
    launches = kernels.ops.launch_counts().get(key, 0) - before
    out_p = plain(*args)
    torch.cuda.synchronize()
    if op == "screen_matvec":
        out_k, out_p = (out_k,), (out_p,)
    err, tol = 0.0, 0.0
    for a, b in zip(out_k, out_p):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        assert bool(torch.isfinite(a).all()), f"{op}: non-finite output"
        err = max(err, float((a - b).abs().max()))
        tol = max(tol, 2e-5 * max(1.0, float(b.abs().max())))
    rows_bitwise = None
    if bf16 and op == "fista_step" and B > 1:
        lam_q = lam.tolist()
        rows_bitwise = all(
            all(torch.equal(a, o[q]) for a, o in zip(kernels.fista_step(
                X, c[q].clone(), z[q].clone(), bo[q].clone(), step,
                lam_q[q], 0.6), out_k)) for q in range(B))
    ms = event_ms(torch, lambda: kern(*args))
    plain_ms = event_ms(torch, lambda: plain(*args))
    c_lib = c.to(X.dtype)
    matmul_ms = event_ms(torch, lambda: torch.matmul(c_lib, X))
    bound_ms, bound_by = bound(op, n, p, B, X.element_size())
    plan = plan_line(kernels, X, B, op, ptxas, wide_p)
    row = {"op": key, "n": n, "p": p, "B": B, "launches_per_call": launches,
           "wide_p": wide_p,
           "params_block": block,
           "max_abs_err": err, "tol": tol,
           "ms": ms, "plain_ms": plain_ms, "matmul_ms": matmul_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "of_bound": bound_ms / ms, "matmul_ratio": ms / matmul_ms,
           "floor_ms": floor_ms, "plan": plan}
    floor = (f"; launch floor {floor_ms:.4f} ms ({ms / floor_ms:.2f}x)"
             if op == "fista_step" else "")
    if rows_bitwise is not None:
        row["rows_bitwise"] = rows_bitwise
        floor += f"; each row the bits of its single launch {rows_bitwise}"
    calls = f" ({launches} launches a call)" if launches > 1 else ""
    print(f"  {key:<19} {n}x{p} B={B}{' params=(3, B)' if block else ''}"
          f"{f' wide_p={wide_p}' if wide_p else ''}"
          f"{calls}: "
          f"max_abs_err={err:.3g} (tol {tol:.3g}) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} matmul_ms={matmul_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) "
          f"{bound_ms / ms:.0%} of bound, {ms / matmul_ms:.2f}x torch.matmul"
          f"{floor}\n      {plan}", flush=True)
    if not err <= tol:
        raise AssertionError(f"{op} {n}x{p} B={B}: kernel disagrees with its "
                             f"plain version: {err} > {tol}")
    if rows_bitwise is False:
        raise AssertionError(f"{key} {n}x{p} B={B}: a row differs from its "
                             f"query's single launch")
    del X, c, args, out_k, out_p
    torch.cuda.empty_cache()
    return row


def cluster_choice(torch, kernels, ref, n: int, p: int, B: int,
                   seed: int) -> dict | None:
    """fista_step at (n, p, B) with its plan's tiles and the rows split over
    clusters of 8, 4 and 2 CTAs and over none (``max_split``), timed in
    turns (8, 4, 2, 1, 1, 2, 4, 8) on the same inputs, each held against
    the plain version (2e-5 of scale); each plan on no rows, its fixed
    cost; and, per launch, runs of RUN back-to-back launches of the plan,
    of ``torch.matmul(r, X)`` and of a 1-element ``zero_()`` (a loop's
    cost, which a single timed launch overstates). None for a tree whose
    wrappers choose no plan."""
    es = kernels.edpp_screen
    if not hasattr(es, "launch_plan"):
        return None
    g = torch.Generator(device="cuda").manual_seed(seed)
    lead = () if B == 1 else (B,)
    X = torch.randn(n, p, generator=g, device="cuda")
    r, z, bo = (torch.randn(*lead, k, generator=g, device="cuda")
                for k in (n, p, p))
    args = (X, r, z, bo, 1.0 / (n + p), 0.7, 0.6)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {k: es.launch_plan(n, p, B, sms, X.data_ptr() % 16 == 0,
                               max_split=k) for k in (8, 4, 2, 1)}
    want = ref.fista_step_ref(*args)
    tol = 2e-5 * max(1.0, max(float(w.abs().max()) for w in want))
    times = {k: [] for k in plans}
    for k in (8, 4, 2, 1, 1, 2, 4, 8):
        out = kernels.fista_step(*args, plan=plans[k])
        err = max(float((a - w).abs().max()) for a, w in zip(out, want))
        assert err <= tol, (k, err, tol)
        times[k].append(event_ms(
            torch, lambda: kernels.fista_step(*args, plan=plans[k])))
    # the fixed cost of each launch: the same plan on no rows (no loads,
    # no FMAs; the barriers, the cluster's sums and the epilogue remain)
    fixed = {k: event_ms(torch, lambda: kernels.fista_step(
        X[:0], r[..., :0], z, bo, 1.0 / (n + p), 0.7, 0.6,
        plan=plans[k]._replace(stage_rows=1))) for k in plans}
    # what a loop pays: ms per launch in a run of RUN back-to-back launches
    one = torch.zeros(1, device="cuda")
    run = {name: event_ms(torch, lambda: [fn() for _ in range(RUN)]) / RUN
           for name, fn in (("fista_step", lambda: kernels.fista_step(*args)),
                            ("torch.matmul", lambda: torch.matmul(r, X)),
                            ("zero_", lambda: one.zero_()))}
    chosen = es.plan_for(X, B).split
    print(f"  fista_step {n}x{p} B={B}, ms by cluster size (turns 8, 4, 2, "
          f"1, 1, 2, 4, 8; the plan takes {chosen}): "
          + "; ".join(f"{plans[k].split}: {times[k][0]:.4f} / "
                      f"{times[k][1]:.4f} (0 rows: {fixed[k]:.4f})"
                      for k in plans)
          + f"; ms per launch in runs of {RUN}: "
          + ", ".join(f"{k} {v:.4f}" for k, v in run.items()), flush=True)
    return {"n": n, "p": p, "B": B, "chosen": chosen,
            "ms": {plans[k].split: times[k] for k in plans},
            "zero_rows_ms": {plans[k].split: fixed[k] for k in plans},
            "ms_per_launch_in_a_run": run}


MESH_RULES = ("gap_cut", "dome")   # the rules phase's mesh arms
# their grids' depth: DOME discards little on the lower half of a 100-λ
# grid, where its wide buckets take over half a minute an arm, so its
# arms run 25 λ over the same range (cut from 100 to keep the smoke's
# time when phases 17 and 18 came)
MESH_RULE_LAMBDAS = {"gap_cut": 100, "dome": 25}


def distributed_phase(torch, X, y) -> dict:
    """Phase 9 (see the module doc). Returns the launch counts of its
    chunked dist_fista runs (set to 0 just before them), and under
    ``"rules"`` those of the MESH_RULES mesh paths."""
    from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
    from repro_torch.core import ScreeningEngine
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    cfg = PathConfig(solve=SolveSpec(tol=1e-6))
    grid = dict(num_lambdas=100, hi_frac=0.95)
    with nccl_world(torch) as mesh:
        walls, res = {}, {}
        for arm in ("unsharded", "mesh", "mesh again", "unsharded again"):
            ops.reset_counts()
            t0 = time.perf_counter()
            sess = LassoSession.fit(X, config=cfg, mesh=mesh if "mesh" in arm
                                    else None)
            res[arm] = sess.path(y, **grid)
            torch.cuda.synchronize()
            walls[arm] = time.perf_counter() - t0
            counted(ops, ("edpp_screen_scores", "screen_matvec",
                          "fista_step"))
            if arm == "mesh":
                mesh_sess = sess
            elif arm == "unsharded":
                plain = sess
        print("path walls (100 λ, tol 1e-6): "
              + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))
        r_u, r_m = res["unsharded"], res["mesh"]
        scale = float(np.abs(r_u.betas).max())
        d_beta = float(np.abs(r_m.betas - r_u.betas).max())
        same = [(a.x_passes, a.n_discarded) == (b.x_passes, b.n_discarded)
                for a, b in zip(r_m.stats, r_u.stats)]
        print(f"mesh session {mesh_sess.backend_name}: masks equal "
              f"{np.array_equal(r_m.masks, r_u.masks)}; max|dbeta| {d_beta:.3g}"
              f" (limit {1e-6 * scale:.3g}); x_passes and n_discarded equal "
              f"at {sum(same)} of {len(same)} steps; fit_passes "
              f"{mesh_sess.fit_passes}")
        assert mesh_sess.backend_name == "shard:cuda"
        assert mesh_sess.fit_passes == 1 and mesh_sess.X.is_cuda
        assert np.array_equal(r_m.masks, r_u.masks) and all(same)
        assert d_beta <= 1e-6 * scale

        ops.reset_counts()
        Xl, yt = D.shard_problem(mesh, X, y)
        lmd = D.make_dist_ops(mesh)[0]
        eng = ScreeningEngine(plain.X, yt, geometry=plain.geometry)
        lam_max = float(lmd(Xl, yt))
        print(f"lambda_max_d {lam_max!r}, session {eng.lam_max!r}")
        assert lam_max == eng.lam_max
        lam_next = 0.5 * lam_max
        mask_e = eng.screen(lam_next, eng.state_at_lambda_max(), "edpp")
        zero = torch.zeros(X.shape[1], device=Xl.device)
        norms = D.place_features(mesh, plain.geometry.col_norms)
        args = (lam_next, eng.lam_max, zero, eng.lam_max, eng.ws.v1_at_lmax)
        xstar = eng.ws.istar
        screens = {
            "dist_edpp_screen": D.dist_edpp_screen(mesh, Xl, yt, *args)[0],
            "dist_edpp_screen_cached": D.dist_edpp_screen_cached(
                mesh, Xl, yt, *args, norms)[1],
            "dist_edpp_screen_sparse": D.dist_edpp_screen_sparse(
                mesh, Xl, Xl[:, [xstar]], yt, lam_next, eng.lam_max,
                zero[[xstar]], eng.lam_max, eng.ws.v1_at_lmax, norms)[1]}
        for name, mask in screens.items():
            diff = int((D.gather_features(mesh, mask) != mask_e).sum())
            print(f"  {name} at 0.5·λ_max from β = 0: {int(mask.sum())} "
                  f"discarded, {diff} differ from the engine's EDPP mask")
            assert diff == 0, name

        t0 = time.perf_counter()
        power = float(D.dist_power_iteration(mesh, Xl, POWER_ITERS))
        torch.cuda.synchronize()
        power_s = time.perf_counter() - t0
        norm2 = float(torch.linalg.matrix_norm(plain.X, 2)) ** 2
        print(f"dist_power_iteration ({POWER_ITERS} iterations, "
              f"{power_s:.3f} s) {power:.6g}, ||X||_2^2 {norm2:.6g}, ratio "
              f"{power / norm2:.6f} (limits [1/1.05, 1 + 1e-5])")
        assert norm2 / 1.05 <= power <= norm2 * (1 + 1e-5)
        counted(ops, ("edpp_screen_scores", "screen_matvec"))

        ops.reset_counts()
        Xl, yt, L, lam, beta_solve, starts = fista_problem(torch, D, mesh, X,
                                                           y)
        counted(ops, ("screen_matvec", "fista_step"))
        fista = {}
        for start, beta0 in starts.items():
            fista[start] = r = fista_readings(torch, D, mesh, Xl, yt, lam, L,
                                              beta0, beta_solve)
            fails = fista_failures(r, y)
            per_iter = ", ".join(
                f"{key} {r[f'{key}_s'] / FISTA_ITERS * 1e3:.4f}"
                for key in ("none", "none_eager", "chunked", "chunked_eager"))
            print(f"  dist_fista from {start}, {FISTA_ITERS} iterations at "
                  f"0.3·λ_max, ms per iteration (captured; eager): "
                  f"{per_iter}; captured bits equal to eager "
                  f"{r['bits_equal']}; chunked vs none {r['rel']:.3g} of "
                  f"max|beta| {r['scale']:.4g} (limit {FISTA_REL_TOL:g}); vs "
                  f"the unsharded solve {r['err_none']:.3g} / "
                  f"{r['err_chunked']:.3g} (limit "
                  f"{beta_err_tol(y, 1e-6):.3g}); failures {fails}")
            assert not fails, fails
        fista_breakdown(torch, D, mesh, Xl, yt)
        block_sweep(torch, D, mesh, Xl, yt, lam, L, starts["zero"])
        launches = {"prox_step": sum(r[f"{key}_launches"]["prox_step"]
                                     for r in fista.values()
                                     for key in ("chunked", "chunked_eager"))}

        B = 8
        rng = np.random.default_rng(1)
        Y = [y]
        for _ in range(B - 1):
            w = np.zeros(X.shape[1], np.float32)
            idx = rng.choice(X.shape[1], 16, replace=False)
            w[idx] = rng.standard_normal(16)
            Y.append(X @ w + 0.05 * rng.standard_normal(X.shape[0]).astype(
                np.float32))
        Yq = D.place_queries(mesh, np.stack(Y))
        ops.reset_counts()
        dots = plain.geometry.backend.matvec(plain.X, Yq)
        istar = dots.abs().argmax(dim=1)
        lam_max_b = dots.abs().amax(dim=1)
        v1_b = torch.sign(dots[torch.arange(B), istar])[:, None] \
            * plain.X[:, istar].T
        zeros = torch.zeros(B, X.shape[1], device=Xl.device)
        mask_b, scores_b = D.dist_edpp_screen_batched(
            mesh, Xl, Yq, 0.5 * lam_max_b, lam_max_b, zeros, lam_max_b, v1_b,
            norms)
        beta_b = D.dist_fista_batched(mesh, Xl, Yq, 0.3 * lam_max_b, zeros, L,
                                      iters=FISTA_ITERS)
        torch.cuda.synchronize()
        batch_launches = ops.launch_counts()
        band = flips = 0
        rel = 0.0
        for b in range(B):
            lm = float(lam_max_b[b])
            scores_1, mask_1 = D.dist_edpp_screen_cached(
                mesh, Xl, Yq[b], 0.5 * lm, lm, zero, lm, v1_b[b], norms)
            near = (scores_1 - (1.0 - 1e-6)).abs() < 1e-4
            band += int(near.sum())
            flips += int((mask_1 != mask_b[b]).sum())
            assert not bool(((mask_1 != mask_b[b]) & ~near).any()), b
            beta_1 = D.dist_fista(mesh, Xl, Yq[b], 0.3 * lm, zero, L,
                                  iters=FISTA_ITERS)
            rel = max(rel, float((beta_1 - beta_b[b]).abs().max())
                      / max(float(beta_1.abs().max()), 1e-30))
        print(f"batched B={B}: dist_edpp_screen_batched vs {B} single "
              f"screens: {flips} mask flips, all within the 1e-4 band "
              f"({band} columns in it); dist_fista_batched vs {B} single "
              f"runs: max relative {rel:.3g} (limit {FISTA_REL_TOL:g}); "
              f"launches {batch_launches}")
        assert rel <= FISTA_REL_TOL
        assert batch_launches["fista_step"] == FISTA_ITERS
        assert not any(ops.plain_counts().values()), ops.plain_counts()

        # the (B, n) batch through the mesh session and the unsharded one
        res_b, walls_b = {}, {}
        for arm, s_ in (("unsharded", plain), ("mesh", mesh_sess)):
            s_.reset_solver_cache()
            ops.reset_counts()
            t0 = time.perf_counter()
            res_b[arm] = s_.path(np.stack(Y), **grid)
            torch.cuda.synchronize()
            walls_b[arm] = time.perf_counter() - t0
            counted(ops, ("screen_matvec", "fista_step"))
        r_u, r_m = res_b["unsharded"], res_b["mesh"]
        scale = float(np.abs(r_u.betas).max())
        d_beta = float(np.abs(r_m.betas - r_u.betas).max())
        same = [(a.x_passes, a.n_discarded) == (b.x_passes, b.n_discarded)
                for a, b in zip(r_m.stats, r_u.stats)]
        print(f"mesh session, (B={B}, n) batch, 100 λ: walls "
              + ", ".join(f"{k} {v:.2f} s" for k, v in walls_b.items())
              + f"; masks equal {np.array_equal(r_m.masks, r_u.masks)}; "
              f"max|dbeta| {d_beta:.3g} (limit {1e-6 * scale:.3g}); x_passes"
              f" and n_discarded equal at {sum(same)} of {len(same)} steps; "
              f"betas {r_m.betas.shape}")
        assert r_m.betas.shape == (B, 100, X.shape[1])
        assert np.array_equal(r_m.masks, r_u.masks) and all(same)
        assert d_beta <= 1e-6 * scale

        # the other screening rules on the mesh session (one all-gather a
        # screen, two for DOME; ĝ from the gathered λ_max column)
        launches["rules"] = dict.fromkeys(ops.OPS, 0)
        for rule in MESH_RULES:
            rcfg = PathConfig(screen=ScreenSpec(rule=rule),
                              solve=SolveSpec(tol=1e-6))
            res_r, walls_r, per_screen = {}, {}, {}
            for arm, s_ in (("unsharded", plain), ("mesh", mesh_sess)):
                s_.reset_solver_cache()
                ops.reset_counts()
                t0 = time.perf_counter()
                res_r[arm] = s_.path(y, **{
                    **grid, "num_lambdas": MESH_RULE_LAMBDAS[rule]},
                    config=rcfg)
                torch.cuda.synchronize()
                walls_r[arm] = time.perf_counter() - t0
                got = counted(ops, ("screen_matvec", "fista_step"))
                live = [s for s in res_r[arm].stats if s.screen_backend]
                per_screen[arm] = (got["screen_matvec"] - 1) / len(live)
                if arm == "mesh":
                    for k, v in got.items():
                        launches["rules"][k] += v
            r_u, r_m = res_r["unsharded"], res_r["mesh"]
            scale = float(np.abs(r_u.betas).max())
            d_beta = float(np.abs(r_m.betas - r_u.betas).max())
            same = [(a.x_passes, a.n_discarded) == (b.x_passes, b.n_discarded)
                    for a, b in zip(r_m.stats, r_u.stats)]
            passes = sorted({s.x_passes for s in r_m.stats if s.screen_backend})
            print(f"mesh session, rule {rule}, {MESH_RULE_LAMBDAS[rule]} λ, "
                  f"tol 1e-6: walls "
                  + ", ".join(f"{k} {v:.2f} s" for k, v in walls_r.items())
                  + f"; masks equal {np.array_equal(r_m.masks, r_u.masks)}; "
                  f"max|dbeta| {d_beta:.3g} (limit {1e-6 * scale:.3g}); "
                  f"x_passes and n_discarded equal at {sum(same)} of "
                  f"{len(same)} steps; x_passes {passes}; screen_matvec "
                  f"launches per screen {per_screen}")
            assert np.array_equal(r_m.masks, r_u.masks) and all(same)
            assert d_beta <= 1e-6 * scale
    return launches


def batch_entry(op: str, rows: dict, batched: dict) -> dict:
    """The batched path's reading of a kernel for the summary line: its
    launches in the counted batched run (FISTA; CD for the Gram sweep)
    and, for the three kernels the batch runs at its own shapes, the
    B = BATCH row's times and bound."""
    key = {"screen_matvec": ("screen_matvec", *MNIST, BATCH),
           "fista_step": "batch_fista", "cd_gram_sweep": "batch_cd"}.get(op)
    if key is None:
        return {}
    r = rows[key]
    src = batched["cd_launches" if op == "cd_gram_sweep" else "launches"]
    return {"batched": {
        "B": BATCH, "launches": src[op],
        "shape": [r["n"], r["p"]] if "n" in r else [r["p"], r["p"]],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r.get("matmul_ms")}}


STACKED = (2, 16)  # rows of a *_cut screen's stacked matvec: B = 1 and 8
def stacked_entry(r: dict) -> dict:
    """A stacked screen_matvec row of phase 3 for the summary line."""
    return {"rows": r["B"], "launches_per_call": r["launches_per_call"],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["matmul_ms"]}


BATCH = 8          # the batched phase's queries: one launch (MAX_B)
BATCH_WIDE = 12    # the screen past MAX_B: two launches
BAND = 1e-4        # score units around 1 − eps where a mask may flip


def band_flips(torch, X64, y, res_one, mask_b) -> tuple[int, int, float]:
    """(flips, columns in the band, the largest |score − threshold| of a
    flipped column) of a batched query's EDPP masks against its single
    run; raises if a flip lies outside the band of the scores the single
    run tested (:func:`rule_margins`)."""
    from repro_torch.core import screening as scr
    flips = band = 0
    worst = 0.0
    for k, pairs in enumerate(rule_margins(torch, scr, X64, y,
                                           res_one.lambdas[0],
                                           res_one.betas[0], "edpp", False)):
        diff = mask_b[k] != res_one.masks[0, k]
        if pairs is None:
            assert not diff.any(), k
            continue
        in_band = near(pairs)
        band += int(in_band.sum())
        flips += int(diff.sum())
        assert not (diff & ~in_band).any(), f"step {k}: a flip outside the band"
        if diff.any():
            worst = max(worst, float(np.abs(pairs[0][0])[diff].max()))
    return flips, band, worst


def split(res, what: str) -> float:
    """A path's seconds in its screens or its solves (``PathStepStats``'
    ``screen_time_s`` / ``solve_time_s``, the host clock)."""
    return sum(getattr(s, f"{what}_time_s") for s in res.stats)


def batched_phase(torch) -> dict:
    """The batched multi-query path at full width (see the module doc):
    FISTA and CD arms of one (BATCH, n) batch against single runs, and one
    screen past MAX_B. Returns the launches of the counted batched FISTA
    run, the CD arm's, and the union buckets the kernel rows are timed
    at."""
    from repro_torch import LassoSession, PathConfig, SolveSpec
    from repro_torch.core import ScreeningEngine
    from repro_torch.core import screening as scr
    from repro_torch.data import QueryStream
    from repro_torch.kernels import ops
    stream = QueryStream(n=MNIST[0], p=MNIST[1], batch=BATCH, nnz=16,
                         sigma=0.05, seed=0)
    X = stream.dictionary(np.float32)
    Y = stream.host_batch(0)["y"].astype(np.float32)
    cfg = PathConfig(solve=SolveSpec(tol=1e-6))
    grid = dict(num_lambdas=100, hi_frac=0.95)
    ops.reset_counts()
    t0 = time.perf_counter()
    sess = LassoSession.fit(X)
    res = sess.path(Y, **grid, config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                             "fista_step"))
    live = [s for s in res.stats if s.screen_backend]
    assert res.betas.shape == (BATCH, 100, MNIST[1]), res.betas.shape
    assert np.isfinite(res.betas).all()
    assert launches["screen_matvec"] <= len(live) + 1, launches
    assert all(s.x_passes == 1 and s.batch_size == BATCH for s in live)
    buckets = [s.bucket for s in live]
    print(f"batched path (B={BATCH}, 100 λ, tol 1e-6) wall {wall:.2f} s; "
          f"{len(live)} live steps; screen_matvec launches "
          f"{launches['screen_matvec']} (limit {len(live) + 1}); fista_step "
          f"{launches['fista_step']}; batched iterations "
          f"{sum(s.solver_iters for s in live)}; query_converged "
          f"{res.query_converged.tolist()}")
    print("union bucket per decile of the grid: " + " ".join(
        f"{np.mean(buckets[k:k + 10]):.0f}" for k in range(0, len(buckets),
                                                          10))
          + f"; median {int(np.median(buckets))}")

    X64 = torch.as_tensor(X, dtype=torch.float64, device="cuda")
    walls, singles, conv1 = [], {}, []
    ops.reset_counts()
    for b in range(BATCH):
        sess.reset_solver_cache()
        t0 = time.perf_counter()
        singles[b] = sess.path(Y[b], res.lambdas[b], config=cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        conv1.append(bool(singles[b].query_converged[0]))
    single_launches = counted(ops, ("screen_matvec", "fista_step"))
    flips = band = 0
    for b in range(BATCH):
        f, n_band, _ = band_flips(torch, X64, Y[b], singles[b], res.masks[b])
        flips, band = flips + f, band + n_band
        err = float(np.abs(res.betas[b] - singles[b].betas[0]).max())
        assert err <= beta_err_tol(Y[b], 1e-6), (b, err)
    print(f"against {BATCH} single runs: {flips} mask flips, all in the "
          f"±{BAND:g} band ({band} step-columns in it); beta within "
          f"beta_err_tol per query; single query_converged {conv1}; walls: "
          f"batched {wall:.2f} s, the {BATCH} single runs {sum(walls):.2f} s "
          f"({' '.join(f'{w:.2f}' for w in walls)}); screen_matvec launches "
          f"batched {launches['screen_matvec']}, singles "
          f"{single_launches['screen_matvec']}; fista_step batched "
          f"{launches['fista_step']}, singles {single_launches['fista_step']}")
    print("host-clock split, batched / the 8 single runs: "
          + "; ".join(f"{what} {split(res, what):.3f} / "
                      f"{sum(split(r, what) for r in singles.values()):.3f}"
                      f" s" for what in ("screen", "solve")))
    del singles, X64

    cd_cfg = PathConfig(solve=SolveSpec(strategy="cd", tol=1e-6))
    sess.reset_solver_cache()
    ops.reset_counts()
    t0 = time.perf_counter()
    res_cd = sess.path(Y, res.lambdas, config=cd_cfg)
    torch.cuda.synchronize()
    cd_wall = time.perf_counter() - t0
    cd_launches = counted(ops, ("screen_matvec", "cd_gram_sweep"))
    live_cd = [s for s in res_cd.stats if s.screen_backend]
    max_epochs = cd_cfg.solve.max_iter // 10 + 1
    gram = [s.gram_step_frac == 1.0 for s in live_cd]
    at_max = sum(s.solver_iters >= max_epochs for s in live_cd)
    errs = [float(np.abs(res_cd.betas[b] - res.betas[b]).max())
            for b in range(BATCH)]
    limits = [min(beta_err_tol(Y[b], 1e-6),
                  CD_REL_TOL * float(np.abs(res.betas[b]).max()))
              for b in range(BATCH)]
    cd_buckets = [s.bucket for s in live_cd]
    print(f"CD arm (B={BATCH}, tol 1e-6) wall {cd_wall:.2f} s; {sum(gram)} "
          f"of {len(live_cd)} steps on cd_gram_sweep at B={BATCH} with "
          f"valid; steps at max_epochs {at_max}; query_converged "
          f"{res_cd.query_converged.tolist()}; cd_gram_sweep launches "
          f"{cd_launches['cd_gram_sweep']}; max|beta_cd - beta_fista| per "
          f"query {[f'{e:.3g}' for e in errs]} (limits "
          f"{[f'{x:.3g}' for x in limits]})")
    assert all(gram) and at_max == 0 and res_cd.query_converged.all()
    assert all(e <= x for e, x in zip(errs, limits))
    del res_cd

    wide = QueryStream(n=MNIST[0], p=MNIST[1], batch=BATCH_WIDE, nnz=16,
                       sigma=0.05, seed=0)
    Yw = torch.as_tensor(wide.host_batch(0)["y"].astype(np.float32),
                         device="cuda")
    geom = sess.geometry
    eng = ScreeningEngine(sess.X, Yw, geometry=geom)
    st = eng.state_at_lambda_max()
    lam = 0.5 * np.asarray(eng.lam_max)
    ops.reset_counts()
    mask_w = eng.screen(lam, st, "edpp")
    torch.cuda.synchronize()
    wide_launches = ops.launch_counts()["screen_matvec"]
    centres = torch.stack([scr.make_sphere("edpp", Yw[b].clone(),
                                           float(lam[b]), st.query(b)).centre
                           for b in range(BATCH_WIDE)])
    dots = geom.backend.matvec(sess.X, centres)
    same = 0
    for b in range(BATCH_WIDE):
        one = ScreeningEngine(sess.X, Yw[b].clone(), geometry=geom)
        st1 = one.state_at_lambda_max()
        same += int(torch.equal(mask_w[b], one.screen(float(lam[b]), st1,
                                                      "edpp"))
                    and torch.equal(dots[b], geom.backend.matvec(
                        sess.X, scr.make_sphere("edpp", one.ws.y,
                                                float(lam[b]),
                                                st1).centre)))
    print(f"screen past MAX_B: B={BATCH_WIDE} in {wide_launches} "
          f"screen_matvec launches; masks and dots bit for bit the single "
          f"screens for {same} of {BATCH_WIDE} queries")
    assert wide_launches == 2 and same == BATCH_WIDE
    return {"launches": launches, "cd_launches": cd_launches,
            "bucket": int(np.median(buckets)),
            "cd_bucket": int(np.median(cd_buckets))}


BASIC_RULES = ("safe", "dome", "strong", "edpp")   # the paper's Fig. 2
BASIC_LAMBDAS = 20   # phase 13(a)'s depth, cut from 100 when phase 14 came,
                     # then from 50 when phase 24 came
SEQ_RULES = (("gap", False), ("strong", False), ("edpp_cut", False),
             ("gap_cut", False), ("edpp", True))  # (rule, hybrid strong)
EXACT_RULES = (("gap", False), ("strong", False), ("dome", False),
               ("dpp_cut", False), ("imp1_cut", False), ("imp2_cut", False),
               ("edpp_cut", False), ("seq_safe_cut", False),
               ("gap_cut", False), ("edpp", True))
BATCH_RULES = ("gap", "edpp_cut", "strong")
# GAP's radius √(2G)/λ is the duality gap at which the previous solve
# stopped: a batched and a single solve of one query both meet the tol,
# at other gaps, so their spheres differ by more than rounding and a flip
# is held to the two paths' own states as well
STATE_RULES = ("gap",)
KKT_TOL = 1e-4     # ScreenSpec's default kkt_tol
DEVICE = "cuda"    # the band scores' and rules phase's device ("cpu" to rehearse)


def rule_name(rule: str, hybrid: bool) -> str:
    return f"{rule}+strong" if hybrid else rule


def rule_margins(torch, scr, X64, y, lambdas, betas, rule: str,
                 kkt: bool) -> list:
    """Per step of a path, each threshold the step tested as a pair of
    numpy arrays (d, w) over the columns: d the float64 score minus the
    threshold, w how close to it a float32 evaluation may flip (BAND;
    for GAP also ‖x_j‖ times the float32 rounding of its radius,
    :func:`gap_radius_err`). The thresholds: the rule's (GAP's rescaled
    sphere, another sequential sphere, a cut's sup over ball ∩
    half-space, the strong rule's 2λ − λ₀) and, with ``kkt``, the KKT
    check's |x_jᵀr|/λ against 1 + tol. Scores come from the path's own
    previous solution, on the card, through the port's screening
    functions in float64; None at λ ≥ λ_max."""
    yd = torch.as_tensor(y, dtype=torch.float64, device=DEVICE)
    norms = scr.col_norms(X64)
    corr = X64.T @ yd
    i = int(torch.argmax(corr.abs()))
    lmax = float(corr[i].abs())
    cut = scr.cut_from_ray(torch.sign(corr[i]) * X64[:, i])
    state = scr.DualState(theta=yd / lmax, lam=lmax,
                          v1=torch.sign(corr[i]) * X64[:, i], at_lmax=True,
                          beta_l1=torch.zeros((), dtype=torch.float64,
                                              device=DEVICE))
    base = rule[:-4] if rule.endswith("_cut") else rule
    out = []
    for lam, beta in zip(lambdas, betas):
        if lam >= lmax:
            out.append(None)
            continue
        width = torch.full_like(norms, BAND)
        if rule == "strong":
            d = (X64.T @ (state.theta * state.lam)).abs() \
                - scr.strong_threshold(lam, state.lam)
        elif base == "gap":
            dot = X64.T @ state.theta
            sup = scr.sup_corr(dot)
            test = scr.gap_sphere(yd, lam, state, sup_corr=sup)
            d = (scr.gap_scores(dot, test, sup, norms) if base == rule
                 else scr.halfspace_sup(dot / torch.clamp(sup, min=1.0),
                                        X64.T @ cut.ghat, norms, test,
                                        cut)) - (1.0 - 1e-6)
            # the radius √(2·G)/λ rounds with the float32 gap G = P − D
            width += gap_radius_err(torch, yd, lam, state, sup) * norms
        elif base == rule:
            test = scr.make_sphere(rule, yd, lam, state)
            d = (X64.T @ test.centre).abs() + test.rho * norms \
                - (1.0 - 1e-6)
        else:
            test = scr.make_sphere(base, yd, lam, state)
            d = scr.halfspace_sup(X64.T @ test.centre, X64.T @ cut.ghat,
                                  norms, test, cut) - (1.0 - 1e-6)
        pairs = [(d.cpu().numpy(), width.cpu().numpy())]
        b = torch.as_tensor(beta, dtype=torch.float64, device=DEVICE)
        if kkt:
            kc = (X64.T @ (yd - X64 @ b)).abs() / lam - (1.0 + KKT_TOL)
            pairs.append((kc.cpu().numpy(), np.full(kc.shape[0], BAND)))
        out.append(pairs)
        theta = (yd - X64 @ b) / lam
        state = scr.DualState(theta=theta, lam=lam, v1=yd / lam - theta,
                              at_lmax=False, beta_l1=b.abs().sum())
    return out


def near(pairs) -> np.ndarray:
    """The columns within their flip width of a threshold of the step."""
    return np.any([np.abs(d) <= w for d, w in pairs], axis=0)


def straddle(pairs_a, pairs_b) -> np.ndarray:
    """The columns that the two paths' own states put on opposite sides
    of a threshold of the step (their float64 scores)."""
    return np.any([da * db < 0 for (da, _), (db, _) in zip(pairs_a,
                                                          pairs_b)], axis=0)


def gap_radius_err(torch, y, lam: float, state, sup) -> float:
    """How far GAP's float32 radius √(2·G)/λ may round from its float64
    value: G = P − D cancels primal and dual values far larger than it,
    and each is a float32 tree sum of depth ≤ 16 (n, p ≤ 65 536), so G
    may be off by δG = 16·2⁻²⁴·(|P| + |D|); the radius then lies within
    [√(2(G − δG)₊), √(2(G + δG))]/λ."""
    centre = state.theta / torch.clamp(sup, min=1.0)
    resid = state.theta * state.lam
    primal = 0.5 * float(resid @ resid) + lam * float(state.beta_l1)
    dual = 0.5 * float(y @ y) - 0.5 * lam * lam * float(
        torch.sum(torch.square(centre - y / lam)))
    gap = max(primal - dual, 0.0)
    d_gap = 16 * 2.0 ** -24 * (abs(primal) + abs(dual))
    return (np.sqrt(2 * (gap + d_gap))
            - np.sqrt(2 * max(gap - d_gap, 0.0))) / lam


def rule_arm(torch, ops, sess, Y, cfg, needed, total, **grid):
    """One path of the rules phase, counted: the launch counters set to 0
    just before it and read after its device sync (every kernel in
    ``needed`` launched, no plain version called), added to ``total``.
    Returns (result, wall seconds, launches)."""
    sess.reset_solver_cache()
    ops.reset_counts()
    t0 = time.perf_counter()
    res = sess.path(Y, config=cfg, **grid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(ops, needed)
    for k, v in launches.items():
        total[k] += v
    assert sess.backend_name in ("cuda", "shard:cuda")
    assert np.isfinite(res.betas).all()
    return res, wall, launches


def rule_readings(name: str, res, wall: float, launches: dict, units: int,
                  passes: int) -> str:
    """The readings of one rule's path: discards per decile, x_passes per
    live step (required to be the engine's count, +1 for hybrid), the
    screen_matvec launches per screen (the |Xᵀy| attach taken out), the
    KKT rounds, and the wall with its host-clock screens and solves."""
    live = [s for s in res.stats if s.screen_backend]
    got = sorted({s.x_passes for s in live})
    assert got == [passes], (name, got, passes)
    per_screen = (launches["screen_matvec"] - 1) / len(live)
    return (f"  {name:<14} deciles {deciles(res, units)}; x_passes {got}; "
            f"screen_matvec launches {launches['screen_matvec']} "
            f"({per_screen:.2f} a screen); kkt rounds "
            f"{sum(s.kkt_rounds for s in res.stats)}; wall {wall:.2f} s "
            f"(screens {split(res, 'screen'):.3f} s, solves "
            f"{split(res, 'solve'):.3f} s)")


def rules_phase(torch, X, y, none_arm) -> dict:
    """The other screening rules at 784 × 50 000 (see the module doc):
    the paper's Fig. 2 basic rules, the sequential rules and hybrid, each
    new rule's exactness against ``none_arm`` (phase 5's unscreened path)
    with cut ⊇ base, and three rules on phase 10's batch against single
    runs. Returns the launches of every arm, summed per op."""
    from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
    from repro_torch.core import ScreeningEngine
    from repro_torch.core import screening as scr
    from repro_torch.core.engine import engine_x_passes
    from repro_torch.data import QueryStream
    from repro_torch.kernels import ops
    n, p = X.shape
    total = dict.fromkeys(ops.OPS, 0)
    solve = SolveSpec(tol=1e-6)
    needed = ("screen_matvec", "fista_step")

    def cfg(rule, hybrid=False, sequential=True):
        return PathConfig(screen=ScreenSpec(rule=rule, strong=hybrid,
                                            sequential=sequential),
                          solve=solve)

    # 1. the paper's Fig. 2: basic rules on unit-normalised columns and y
    # (BASIC_LAMBDAS λ: the depth cut of this phase)
    X64 = X.astype(np.float64)
    Xn = (X64 / (np.linalg.norm(X64, axis=0, keepdims=True) + 1e-30))
    yn = y.astype(np.float64) / np.linalg.norm(y.astype(np.float64))
    sess = LassoSession.fit(Xn.astype(np.float32), device=DEVICE)
    print(f"basic rules (sequential=False), unit-normalised columns and y, "
          f"{BASIC_LAMBDAS} λ, tol 1e-6:")
    for rule in BASIC_RULES:
        res, wall, got = rule_arm(torch, ops, sess, yn.astype(np.float32),
                                  cfg(rule, sequential=False), needed, total,
                                  num_lambdas=BASIC_LAMBDAS)
        print(rule_readings(rule, res, wall, got, p, engine_x_passes(rule)))
    del sess

    # 2. the sequential rules and hybrid safe+strong on the default data
    sess = LassoSession.fit(X, device=DEVICE)
    print("sequential rules, 100 λ, tol 1e-6:")
    for rule, hybrid in SEQ_RULES:
        res, wall, got = rule_arm(torch, ops, sess, y, cfg(rule, hybrid),
                                  needed, total, num_lambdas=100)
        print(rule_readings(rule_name(rule, hybrid), res, wall, got, p,
                            engine_x_passes(rule) + int(hybrid)))

    # 3. exactness against phase 5's unscreened path, on its grid
    b_n = none_arm.betas[0]
    grid = none_arm.lambdas[0]
    needed_cols = np.abs(b_n) > 1e-6 * np.abs(b_n).max()
    tol = beta_err_tol(y, 1e-6)
    print(f"exactness against the unscreened path (20 λ, hi_frac 0.95, tol "
          f"1e-6; limit {tol:.3g}):")
    paths = {}
    for rule, hybrid in EXACT_RULES:
        name = rule_name(rule, hybrid)
        res, wall, got = rule_arm(torch, ops, sess, y, cfg(rule, hybrid),
                                  needed, total, lambdas=grid)
        paths[name] = res
        err = float(np.abs(res.betas[0] - b_n).max())
        unsafe = int((res.masks[0] & needed_cols).sum())
        print(f"  {name:<14} max|beta - beta_none| {err:.3g}; unsafe "
              f"discards {unsafe}; mean discard fraction "
              f"{res.masks[0].mean():.4f}; kkt rounds "
              f"{sum(s.kkt_rounds for s in res.stats)}; wall {wall:.2f} s")
        assert err <= tol and unsafe == 0, name
    # cut ⊇ base: from one state at every step, the cut screen discards
    # whatever the base screen does (the same state, so the same sphere):
    # the base path's states where (c) ran it, else the cut path's own;
    # the two paths' masks are printed beside it where both ran
    eng = ScreeningEngine(sess.X, torch.as_tensor(y, device=DEVICE),
                          geometry=sess.geometry)
    for base in ("dpp", "imp1", "imp2", "edpp", "seq_safe", "gap"):
        cut_path = paths[base + "_cut"]
        ref_path = paths.get(base)
        states, src = ((ref_path, base) if ref_path is not None
                       else (cut_path, base + "_cut"))
        state, missed, extra = eng.state_at_lambda_max(), 0, 0
        for k, lam in enumerate(grid):
            if lam >= eng.lam_max:
                continue
            m_base = eng.screen(float(lam), state, base)
            m_cut = eng.screen(float(lam), state, base + "_cut")
            missed += int((m_base & ~m_cut).sum())
            extra += int((m_cut & ~m_base).sum())
            beta = torch.as_tensor(states.betas[0, k], dtype=torch.float32,
                                   device=DEVICE)
            state = eng.make_state(beta, float(lam))
        on_paths = ("" if ref_path is None else "; on the two paths "
                    f"{int((ref_path.masks[0] & ~cut_path.masks[0]).sum())}")
        print(f"  {base}_cut ⊇ {base}: from {src}'s states, columns the cut "
              f"keeps and {base} discards {missed} (cut discards {extra} "
              f"more){on_paths}")
        assert missed == 0, base
    del sess, eng

    # 4. phase 10's batch: each query against its single run
    stream = QueryStream(n=n, p=p, batch=BATCH, nnz=16, sigma=0.05, seed=0)
    Xb = stream.dictionary(np.float32)
    Y = stream.host_batch(0)["y"].astype(np.float32)
    sess = LassoSession.fit(Xb, device=DEVICE)
    Xd64 = torch.as_tensor(Xb, dtype=torch.float64, device=DEVICE)
    print(f"batched (B={BATCH}) against single runs, 100 λ, hi_frac 0.95, "
          f"tol 1e-6:")
    for rule in BATCH_RULES:
        res, wall, got = rule_arm(torch, ops, sess, Y, cfg(rule), needed,
                                  total, num_lambdas=100, hi_frac=0.95)
        print(rule_readings(f"{rule} B={BATCH}", res, wall, got, p,
                            engine_x_passes(rule)))
        flips = band = by_state = 0
        walls = []
        for b in range(BATCH):
            one, w1, _ = rule_arm(torch, ops, sess, Y[b], cfg(rule), needed,
                                  total, lambdas=res.lambdas[b])
            walls.append(w1)
            kkt = rule == "strong"
            single = rule_margins(torch, scr, Xd64, Y[b], one.lambdas[0],
                                  one.betas[0], rule, kkt)
            own = rule_margins(torch, scr, Xd64, Y[b], res.lambdas[b],
                               res.betas[b], rule, kkt) \
                if rule in STATE_RULES else single
            for k, (m_one, m_own) in enumerate(zip(single, own)):
                diff = res.masks[b, k] != one.masks[0, k]
                if m_one is None:
                    assert not diff.any(), (rule, b, k)
                    continue
                in_band = near(m_one)
                band += int(in_band.sum())
                flips += int(diff.sum())
                if rule in STATE_RULES:
                    # a flip the two paths' states explain: one of them
                    # puts the column on the threshold, or they put it on
                    # opposite sides
                    by_state += int((diff & ~in_band).sum())
                    in_band = in_band | near(m_own) | straddle(m_one, m_own)
                assert not (diff & ~in_band).any(), (rule, b, k, "outside")
            err = float(np.abs(res.betas[b] - one.betas[0]).max())
            assert err <= beta_err_tol(Y[b], 1e-6), (rule, b, err)
        widened = (" (widened by the radius' float32 rounding)"
                   if rule in STATE_RULES else "")
        print(f"    against {BATCH} single runs: {flips} mask flips, "
              f"{flips - by_state} in the single run's ±{BAND:g} "
              f"band{widened} ({band} step-columns in it), {by_state} "
              f"explained by the two paths' states, none else; beta within "
              f"beta_err_tol per query; walls batched {wall:.2f} s, singles "
              f"{sum(walls):.2f} s")
    del sess, Xd64
    return {"launches": total, "grid": grid}


BF16_CASES = ((*MNIST, 1), (*MNIST, 8), (*MNIST, 16), (*SVHN, 1))
BF16_BATCH_RULES = ("edpp", "gap", "edpp_cut")
# the solver's iterations a step (max_iter) on both arms of every bf16
# rule's comparison on phase 5's grid: the two arms run the same solves
# on the same masks, so the cap keeps the check whole (masks equal, β bit
# for bit) and cuts the depth of each solve (from 5 000, with phase 13's
# arms reused as the float32 ones, when phase 24 came)
BF16_RULE_MAX_ITER = 500


def bf16_deciles(arms: dict) -> str:
    """Per tenth of a 100-λ path, for each arm: the band columns re-tested
    in float32, the passes over X, the screen bytes (MB) and the screens'
    host-clock seconds, summed over the tenth's steps."""
    lines = []
    for name, res in arms.items():
        st = res.stats
        parts = []
        for k in range(0, len(st), 10):
            d = st[k:k + 10]
            parts.append(f"{sum(s.fallback_cols for s in d)}/"
                         f"{sum(s.x_passes for s in d)}/"
                         f"{sum(s.screen_bytes for s in d) / 1e6:.0f}/"
                         f"{sum(s.screen_time_s for s in d):.3f}")
        lines.append(f"    {name:<8} " + " ".join(parts))
    return "\n".join(lines)


def bf16_phase(torch, X, y, rules: dict, solved: dict) -> dict:
    """The mixed-precision screen at 784 × 50 000 (see the module doc):
    the 100-λ EDPP path in bf16 against float32, every bf16 rule on phase
    5's 20-λ grid against its own float32 arm (both at
    ``BF16_RULE_MAX_ITER`` iterations a step), phase 10's batch in bf16
    against float32, and ``solve --screen-dtype
    bfloat16`` against phase 12's solve; the float32 re-test's dots against
    the wide pass's. Each bf16 mask must equal its float32 mask at every
    step. Returns the launches of the bf16 EDPP path and of every arm."""
    import collections

    from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
    from repro_torch.core.engine import BF16_FAST_RULES, _narrow_bucket
    from repro_torch.data import QueryStream
    from repro_torch.kernels import edpp_screen, ops
    from repro_torch.launch import solve as solve_cli
    n, p = X.shape
    total = collections.Counter()
    solve = SolveSpec(tol=1e-6)
    needed = {"float32": ("screen_matvec", "fista_step"),
              "bfloat16": ("screen_matvec_bf16", "fista_step")}

    def cfg(rule, dtype, solve=solve):
        return PathConfig(screen=ScreenSpec(rule=rule, screen_dtype=dtype),
                          solve=solve)

    def same(a, b, what):
        eq = np.array_equal(a.masks, b.masks)
        beq = np.array_equal(a.betas, b.betas)
        live = [s for s in b.stats if s.screen_backend]
        assert eq, f"{what}: bf16 masks differ from float32 at " \
            f"{int((a.masks != b.masks).sum())} step-columns"
        assert all(s.screen_dtype_effective == "bfloat16" for s in live), \
            what
        return beq, live

    # 0. the float32 re-test's bits: gathers of the data's columns (16
    # stacked rows, a cut's batch) summed as the wide pass sums them
    Xd = torch.as_tensor(X, device=DEVICE)
    C = torch.as_tensor(np.random.default_rng(7).standard_normal((16, n)),
                        dtype=torch.float32, device=DEVICE)
    wide = edpp_screen.screen_matvec(Xd, C)
    for k in (8, 24, 48):
        cols = np.sort(np.random.default_rng(k).choice(p, k, replace=False))
        bucket = _narrow_bucket(k + 1, p)
        Xn = torch.zeros((n, bucket), device=DEVICE)
        Xn[:, :k] = Xd[:, cols]
        got = edpp_screen.screen_matvec(Xn, C, wide_p=p)
        idx = torch.as_tensor(cols, device=DEVICE)
        assert torch.equal(got[:, :k], wide[:, idx]), k
    print("float32 re-test: gathers of 8, 24 and 48 columns (buckets 16, "
          "32, 64; 16 rows) give the wide pass's dots bit for bit")
    del Xd, C, wide, Xn, got

    # 1. the 100-λ EDPP path, float32 then bf16, each counted
    sess = LassoSession.fit(X, device=DEVICE)
    arms, walls, main = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        res, walls[dtype], got = rule_arm(torch, ops, sess, y,
                                          cfg("edpp", dtype),
                                          needed[dtype], total,
                                          num_lambdas=100)
        arms[dtype] = res
        main[dtype] = got
    beq, live = same(arms["float32"], arms["bfloat16"], "edpp 100 λ")
    b32 = sum(s.screen_bytes for s in arms["float32"].stats)
    b16 = sum(s.screen_bytes for s in arms["bfloat16"].stats)
    print(f"edpp, 100 λ, tol 1e-6: bf16 masks equal to float32 at every "
          f"step, betas bit for bit {beq}; re-tested columns "
          f"{sum(s.fallback_cols for s in live)} over {len(live)} screens "
          f"({sum(s.x_passes == 2 for s in live)} with a re-test); screen "
          f"bytes {b16 / 1e6:.1f} MB against {b32 / 1e6:.1f} MB "
          f"({b16 / b32:.3f}); screens "
          f"{split(arms['bfloat16'], 'screen'):.3f} s against "
          f"{split(arms['float32'], 'screen'):.3f} s; walls "
          f"{walls['bfloat16']:.2f} s against {walls['float32']:.2f} s")
    print("  per tenth of the grid: re-tested columns / passes / screen MB "
          "/ screen s")
    print(bf16_deciles(arms))

    # 2. every bf16 rule on phase 5's 20-λ grid, both arms capped at
    # BF16_RULE_MAX_ITER iterations a step
    grid = rules["grid"]
    capped = SolveSpec(tol=1e-6, max_iter=BF16_RULE_MAX_ITER)
    print(f"every bf16 rule on phase 5's grid (20 λ, tol 1e-6, max_iter "
          f"{BF16_RULE_MAX_ITER}), against its float32 arm:")
    for rule in BF16_FAST_RULES:
        f32, wall32, _ = rule_arm(torch, ops, sess, y,
                                  cfg(rule, "float32", capped),
                                  needed["float32"], total, lambdas=grid)
        res, wall, _ = rule_arm(torch, ops, sess, y,
                                cfg(rule, "bfloat16", capped),
                                needed["bfloat16"], total, lambdas=grid)
        beq, live = same(f32, res, rule)
        ratio = (sum(s.screen_bytes for s in res.stats)
                 / sum(s.screen_bytes for s in f32.stats))
        print(f"  {rule:<13} masks equal, betas bit for bit {beq}; "
              f"re-tested columns {sum(s.fallback_cols for s in live)}; "
              f"x_passes {sorted({s.x_passes for s in live})}; screen "
              f"bytes {ratio:.3f} of float32; walls {wall:.2f} s against "
              f"{wall32:.2f} s")
    del sess

    # 3. phase 10's batch
    stream = QueryStream(n=n, p=p, batch=BATCH, nnz=16, sigma=0.05, seed=0)
    Xb = stream.dictionary(np.float32)
    Y = stream.host_batch(0)["y"].astype(np.float32)
    sess = LassoSession.fit(Xb, device=DEVICE)
    print(f"phase 10's batch (B={BATCH}), 100 λ, hi_frac 0.95, tol 1e-6:")
    for rule in BF16_BATCH_RULES:
        out, w = {}, {}
        for dtype in ("float32", "bfloat16"):
            out[dtype], w[dtype], _ = rule_arm(
                torch, ops, sess, Y, cfg(rule, dtype), needed[dtype], total,
                num_lambdas=100, hi_frac=0.95)
        beq, live = same(out["float32"], out["bfloat16"], f"{rule} B=8")
        print(f"  {rule:<9} B={BATCH}: masks equal at every step, betas bit "
              f"for bit {beq}; re-tested columns "
              f"{sum(s.fallback_cols for s in live)}; walls "
              f"{w['bfloat16']:.2f} s against {w['float32']:.2f} s")
    del sess

    # 4. solve --screen-dtype bfloat16 against phase 12's solve
    ops.reset_counts()
    t0 = time.perf_counter()
    res = solve_cli.main(["--n", str(n), "--p", str(p), "--nnz", "16",
                          "--no-x64", "--num-lambdas", "20",
                          "--screen-dtype", "bfloat16"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(ops, needed["bfloat16"])
    total.update(launches)
    f32 = solved["result"]
    assert np.array_equal(res.masks, f32.masks), "solve: masks differ"
    live = [s for s in res.stats if s.screen_backend]
    assert all(s.screen_dtype_effective == "bfloat16" for s in live)
    print(f"solve --screen-dtype bfloat16 (20 λ, tol 1e-8): masks equal to "
          f"phase 12's float32 solve, betas bit for bit "
          f"{np.array_equal(res.betas, f32.betas)}; wall {wall:.2f} s; "
          f"launches screen_matvec_bf16 "
          f"{launches.get('screen_matvec_bf16', 0)}")
    return {"main": main["bfloat16"], "total": dict(total)}


# phase 3's bf16 fista_step cases (n, p, B, params block): the solver's
# narrowest bucket on a cluster of 4, the batched path's median bucket
# with a ready (3, B) block, a bucket whose rows split over a cluster, and
# a ragged p on scalar loads
BF16_FISTA_CASES = ((784, 32, 1, False), (784, 128, BATCH, True),
                    (784, 512, 1, False), (777, 1001, 3, False))


def solve_flips(torch, X64, y, res_a, res_b) -> tuple[int, int, int]:
    """(flips, of them within the ±BAND band of an EDPP threshold that
    either path tested from its own previous solution, and the rest, each
    a column the two paths' own states put on opposite sides of the
    threshold) of two single-query paths on one grid, in the squeezed
    layout; raises on a flip that is neither. A bf16 solve's certified
    stop lands on another β than the float32 stop, so the two paths'
    states differ by a solve's tolerance."""
    from repro_torch.core import screening as scr
    lam = res_a.lambdas
    pa = rule_margins(torch, scr, X64, y, lam, res_a.betas, "edpp", False)
    pb = rule_margins(torch, scr, X64, y, lam, res_b.betas, "edpp", False)
    flips = band = across = 0
    for k, (a, b) in enumerate(zip(pa, pb)):
        diff = res_a.masks[k] != res_b.masks[k]
        if a is None:
            assert not diff.any(), k
            continue
        in_band = near(a) | near(b)
        cross = straddle(a, b) & ~in_band
        assert not (diff & ~in_band & ~cross).any(), \
            f"step {k}: a flip outside the band that no state explains"
        flips += int(diff.sum())
        band += int((diff & in_band).sum())
        across += int((diff & cross).sum())
    return flips, band, across


def solve_deciles(arms: dict) -> str:
    """Per tenth of a path, for each arm: bf16-phase / total solver
    iterations, solve MB (the reference's byte model) and the solves'
    host-clock seconds, summed over the tenth's steps."""
    lines = []
    for name, res in arms.items():
        st = res.stats
        parts = []
        step = max(1, len(st) // 10)
        for k in range(0, len(st), step):
            d = st[k:k + step]
            parts.append(f"{sum(s.solver_lo_iters for s in d)}/"
                         f"{sum(s.solver_iters for s in d)}/"
                         f"{sum(s.solve_bytes for s in d) / 1e6:.0f}/"
                         f"{sum(s.solve_time_s for s in d):.3f}")
        lines.append(f"    {name:<9} " + " ".join(parts))
    return "\n".join(lines)


def bf16_live(res, name: str, gram_max: int | None = None) -> list:
    """The live steps of a bf16-solve path, checked: each on the bf16
    stream (a cd bucket past ``gram_max`` columns: matvec CD, float32),
    and each step that iterated with iterations in its bf16 phase."""
    live = [s for s in res.stats if s.screen_backend]
    assert live, name
    for s in live:
        lo_side = gram_max is None or s.bucket <= gram_max
        want = "bfloat16" if lo_side else "float32"
        assert s.solve_dtype_effective == want, (name, s)
        if lo_side and s.solver_iters > 0:
            assert s.solver_lo_iters > 0, (name, s)
        if not lo_side:
            assert s.solver_lo_iters == 0, (name, s)
    return live


def bf16_solve_phase(torch, X, y, solved: dict) -> dict:
    """The mixed-precision solve at 784 × 50 000 (see the module doc):
    (a) the 100-λ EDPP path with ``solve_dtype="bfloat16"`` against its
    float32 arm, (b) with the bf16 screen too, (c) ``strategy="cd"`` in
    bf16 against its float32 arm, (d) phase 10's batch in bf16 against its
    float32 batch, (e) ``solve --solve-dtype bfloat16`` against phase 12's
    solve. Each arm counted after ``reset_solver_cache()``. Returns the
    launches of (a)'s bf16 arm and of every arm."""
    import collections

    from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
    from repro_torch.data import QueryStream, lasso_problem
    from repro_torch.kernels import ops
    from repro_torch.launch import solve as solve_cli
    n, p = X.shape
    total = collections.Counter()
    X64 = torch.as_tensor(X, dtype=torch.float64, device=DEVICE)

    def cfg(solve_dtype, screen_dtype="float32", strategy=None):
        return PathConfig(
            screen=ScreenSpec(screen_dtype=screen_dtype),
            solve=SolveSpec(strategy=strategy, tol=1e-6,
                            solve_dtype=solve_dtype))

    need = {"f32": ("screen_matvec", "fista_step"),
            "bf16": ("screen_matvec", "fista_step_bf16"),
            "both": ("screen_matvec_bf16", "fista_step_bf16"),
            "cd": ("screen_matvec", "cd_gram_sweep")}
    sess = LassoSession.fit(X, device=DEVICE)
    arms, walls, got = {}, {}, {}
    for name, c, needed in (("float32", cfg("float32"), need["f32"]),
                            ("bf16", cfg("bfloat16"), need["bf16"]),
                            ("bf16+scr", cfg("bfloat16", "bfloat16"),
                             need["both"]),
                            ("cd f32", cfg("float32", strategy="cd"),
                             need["cd"]),
                            ("cd bf16", cfg("bfloat16", strategy="cd"),
                             need["cd"])):
        arms[name], walls[name], got[name] = rule_arm(
            torch, ops, sess, y, c, needed, total, num_lambdas=100)
    assert got["cd bf16"].get("fista_step_bf16", 0) == 0
    assert got["cd bf16"].get("fista_step", 0) == 0
    tol = beta_err_tol(y, 1e-6)
    print("(a, b) the 100-λ EDPP path, tol 1e-6, bf16 solve against "
          "float32:")
    for name in ("bf16", "bf16+scr"):
        res = arms[name]
        live = bf16_live(res, name)
        err = float(np.abs(res.betas - arms["float32"].betas).max())
        flips, band, across = solve_flips(
            torch, X64, y, arms["float32"].squeeze(), res.squeeze())
        print(f"  {name:<9} max|dbeta| {err:.3g} (tol {tol:.3g}); mask "
              f"flips {flips} ({band} in the band, {across} across the "
              f"two states); bf16-phase iterations "
              f"{sum(s.solver_lo_iters for s in live)} of "
              f"{sum(s.solver_iters for s in live)} (float32 arm "
              f"{sum(s.solver_iters for s in arms['float32'].stats)}); "
              f"fista_step_bf16 {got[name].get('fista_step_bf16', 0)}, "
              f"fista_step {got[name].get('fista_step', 0)}; wall "
              f"{walls[name]:.2f} s against {walls['float32']:.2f} s "
              f"(solves {split(res, 'solve'):.3f} s against "
              f"{split(arms['float32'], 'solve'):.3f} s)")
        assert err <= tol, (name, err, tol)
    print("  per tenth of the grid: bf16-phase / total iterations / solve "
          "MB / solve s")
    print(solve_deciles({k: arms[k] for k in ("float32", "bf16",
                                              "bf16+scr")}))
    res = arms["cd bf16"]
    live = bf16_live(res, "cd bf16", gram_max=min(n, ops.GRAM_BUCKET_MAX))
    max_epochs = SolveSpec().max_iter // 10 + 1
    r = cd_readings(res, arms["cd f32"], max_epochs)
    fails = cd_failures(r, y)
    flips, band, across = solve_flips(torch, X64, y,
                                      arms["cd f32"].squeeze(),
                                      res.squeeze())
    print(f"(c) cd, 100 λ, tol 1e-6: max|beta_cd_bf16 - beta_cd_f32| = "
          f"{r['err']:.3g} (limits {tol:.3g} and {CD_REL_TOL:g}·max|beta| "
          f"= {CD_REL_TOL * r['scale']:.3g}); failures {fails}; mask flips "
          f"{flips} ({band} in the band, {across} across); "
          f"{sum(s.solve_dtype_effective == 'bfloat16' for s in live)} of "
          f"{len(live)} live steps in bf16; bf16-phase sweeps "
          f"{sum(s.solver_lo_iters for s in live)} of "
          f"{sum(s.solver_iters for s in live)}; cd_gram_sweep "
          f"{got['cd bf16']['cd_gram_sweep']} (float32 arm "
          f"{got['cd f32']['cd_gram_sweep']}); walls {walls['cd bf16']:.2f} "
          f"s against {walls['cd f32']:.2f} s")
    assert not fails, fails
    main = got["bf16"]
    del sess, arms

    # (d) phase 10's batch
    stream = QueryStream(n=n, p=p, batch=BATCH, nnz=16, sigma=0.05, seed=0)
    Xb = stream.dictionary(np.float32)
    Y = stream.host_batch(0)["y"].astype(np.float32)
    sess = LassoSession.fit(Xb, device=DEVICE)
    out, w = {}, {}
    for dtype, needed in (("float32", need["f32"]), ("bfloat16",
                                                     need["bf16"])):
        out[dtype], w[dtype], got[dtype] = rule_arm(
            torch, ops, sess, Y, cfg(dtype), needed, total, num_lambdas=100,
            hi_frac=0.95)
    live = bf16_live(out["bfloat16"], "batch")
    Xb64 = torch.as_tensor(Xb, dtype=torch.float64, device=DEVICE)
    flips = band = across = 0
    for b in range(BATCH):
        err = float(np.abs(out["bfloat16"].betas[b]
                           - out["float32"].betas[b]).max())
        assert err <= beta_err_tol(Y[b], 1e-6), (b, err)
        f, n_band, n_across = solve_flips(
            torch, Xb64, Y[b], out["float32"].query(b),
            out["bfloat16"].query(b))
        flips, band, across = flips + f, band + n_band, across + n_across
    print(f"(d) phase 10's batch (B={BATCH}, 100 λ, hi_frac 0.95, tol "
          f"1e-6): β within beta_err_tol per query; mask flips {flips} "
          f"({band} in the band, {across} across); bf16-phase iterations "
          f"{sum(s.solver_lo_iters for s in live)} of "
          f"{sum(s.solver_iters for s in live)}; fista_step_bf16 "
          f"{got['bfloat16'].get('fista_step_bf16', 0)}; walls "
          f"{w['bfloat16']:.2f} s against {w['float32']:.2f} s")
    del sess, Xb64, out

    # (e) solve --solve-dtype bfloat16 against phase 12's solve
    ops.reset_counts()
    t0 = time.perf_counter()
    res = solve_cli.main(["--n", str(n), "--p", str(p), "--nnz", "16",
                          "--no-x64", "--num-lambdas", "20",
                          "--solve-dtype", "bfloat16"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(ops, need["bf16"])
    total.update(launches)
    live = bf16_live(res, "solve")
    f32 = solved["result"]
    Xs, ys, _ = lasso_problem(n, p, nnz=16, dtype=np.float32)
    Xs64 = torch.as_tensor(Xs, dtype=torch.float64, device=DEVICE)
    flips, band, across = solve_flips(torch, Xs64, ys, f32, res)
    err = float(np.abs(res.betas - f32.betas).max())
    print(f"(e) solve --solve-dtype bfloat16 (20 λ, tol 1e-8): wall "
          f"{wall:.2f} s; mask flips against phase 12's float32 solve "
          f"{flips} ({band} in the band, {across} across); max|dbeta| "
          f"{err:.3g} (beta_err_tol at 1e-8 {beta_err_tol(ys, 1e-8):.3g}); "
          f"bf16-phase iterations {sum(s.solver_lo_iters for s in live)} "
          f"of {sum(s.solver_iters for s in live)}; launches "
          f"fista_step_bf16 {launches.get('fista_step_bf16', 0)}, "
          f"fista_step {launches['fista_step']}")
    assert err <= beta_err_tol(ys, 1e-8), err
    return {"main": main, "total": dict(total)}


def batch_from(X, y, batch: int, seed: int) -> np.ndarray:
    """(batch, n) queries against X: y, then 16-sparse Gaussian truths with
    noise 0.05 (make_dataset's recipe), from ``seed``."""
    rng = np.random.default_rng(seed)
    n, p = X.shape
    rows = [y]
    for _ in range(batch - 1):
        w = np.zeros(p)
        idx = rng.choice(p, 16, replace=False)
        w[idx] = rng.standard_normal(idx.size)
        rows.append(X @ w + 0.05 * rng.standard_normal(n))
    return np.stack(rows).astype(np.float32)


def mesh_bf16_phase(torch, X, y, solved: dict) -> dict:
    """Phase 17, mixed precision on a (1, 1) NCCL mesh at 784 × 50 000
    (see the module doc): (a) the bf16 screen against the mesh's float32
    arm, bit for bit; (b) bf16 ``fista``, (c) bf16 ``cd`` and (d) a
    B = 8 batch in bf16, each against the unsharded bf16-solve arm; (e)
    ``solve --mesh 1x1 --screen-dtype bfloat16 --solve-dtype bfloat16``
    against phase 12's solve. Every arm counted after
    ``reset_solver_cache()``. Returns the launches of the mesh arms and of
    (e)."""
    import collections

    from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
    from repro_torch.data import lasso_problem
    from repro_torch.kernels import ops
    from repro_torch.launch import solve as solve_cli
    n, p = X.shape
    mesh_total, total = collections.Counter(), collections.Counter()
    X64 = torch.as_tensor(X, dtype=torch.float64, device=DEVICE)
    grid = dict(num_lambdas=100, hi_frac=0.95)
    Y = batch_from(X, y, BATCH, seed=17)

    def cfg(screen="float32", solve="float32", strategy=None):
        return PathConfig(
            screen=ScreenSpec(screen_dtype=screen),
            solve=SolveSpec(strategy=strategy, tol=1e-6, solve_dtype=solve))

    fista = ("screen_matvec", "fista_step_bf16")
    cd = ("screen_matvec", "cd_gram_sweep")
    arms, walls, got = {}, {}, {}
    with nccl_world(torch) as mesh:
        msess = LassoSession.fit(X, mesh=mesh, device=DEVICE)
        plain = LassoSession.fit(X, device=DEVICE)
        assert msess.backend_name == "shard:cuda"
        for name, sess, Yq, c, needed in (
                ("mesh f32", msess, y, cfg(), ("screen_matvec",
                                                "fista_step")),
                ("mesh bf16 screen", msess, y, cfg(screen="bfloat16"),
                 ("screen_matvec_bf16", "screen_matvec", "fista_step")),
                ("mesh fista", msess, y, cfg(solve="bfloat16"), fista),
                ("fista", plain, y, cfg(solve="bfloat16"), fista),
                ("mesh cd", msess, y, cfg(solve="bfloat16", strategy="cd"),
                 cd),
                ("cd", plain, y, cfg(solve="bfloat16", strategy="cd"), cd),
                ("mesh batch", msess, Y, cfg(solve="bfloat16"), fista),
                ("batch", plain, Y, cfg(solve="bfloat16"), fista)):
            arms[name], walls[name], got[name] = rule_arm(
                torch, ops, sess, Yq, c, needed,
                mesh_total if name.startswith("mesh") else total, **grid)
        for name in ("mesh bf16 screen", "mesh fista", "mesh batch"):
            assert got[name].get("fista_step_bf16" if "screen" not in name
                                 else "screen_matvec_bf16", 0) > 0, name
        assert got["mesh cd"].get("fista_step_bf16", 0) == 0
    r32, r16 = arms["mesh f32"], arms["mesh bf16 screen"]
    live = [s for s in r16.stats if s.screen_backend]
    same = np.array_equal(r16.masks, r32.masks)
    print(f"(a) mesh bf16 screen, 100-λ EDPP, tol 1e-6: masks equal to the "
          f"mesh's float32 masks at every step {same}; β equal "
          f"{np.array_equal(r16.betas, r32.betas)}; every screened step "
          f"bf16 {all(s.screen_dtype_effective == 'bfloat16' for s in live)}"
          f"; columns re-tested in float32 "
          f"{sum(s.fallback_cols for s in live)}; screen MB "
          f"{sum(s.screen_bytes for s in r16.stats) / 1e6:.1f} against "
          f"{sum(s.screen_bytes for s in r32.stats) / 1e6:.1f}; "
          f"screen_matvec_bf16 {got['mesh bf16 screen']['screen_matvec_bf16']}"
          f"; walls {walls['mesh bf16 screen']:.2f} s against "
          f"{walls['mesh f32']:.2f} s")
    assert same and all(s.screen_dtype_effective == "bfloat16" for s in live)
    tol = beta_err_tol(y, 1e-6)
    for name, gram in (("fista", None), ("cd", min(n, ops.GRAM_BUCKET_MAX))):
        mres, res = arms[f"mesh {name}"], arms[name]
        mlive = bf16_live(mres, f"mesh {name}", gram_max=gram)
        err = float(np.abs(mres.betas - res.betas).max())
        flips, band, across = solve_flips(torch, X64, y, res.squeeze(),
                                          mres.squeeze())
        print(f"({'b' if name == 'fista' else 'c'}) mesh bf16 {name} "
              f"against the unsharded bf16 {name}: mask flips {flips} "
              f"({band} in the band, {across} across the two states); "
              f"max|dbeta| {err:.3g} (tol {tol:.3g}); bf16-phase "
              f"iterations {sum(s.solver_lo_iters for s in mlive)} of "
              f"{sum(s.solver_iters for s in mlive)} (unsharded "
              f"{sum(s.solver_lo_iters for s in res.stats)} of "
              f"{sum(s.solver_iters for s in res.stats)}); walls "
              f"{walls[f'mesh {name}']:.2f} s against {walls[name]:.2f} s")
        assert err <= tol, (name, err, tol)
        assert sum(s.solver_lo_iters for s in mlive) > 0
    mres, res = arms["mesh batch"], arms["batch"]
    bf16_live(mres, "mesh batch")
    flips = band = across = 0
    for b in range(BATCH):
        err = float(np.abs(mres.betas[b] - res.betas[b]).max())
        assert err <= beta_err_tol(Y[b], 1e-6), (b, err)
        f, nb, na = solve_flips(torch, X64, Y[b], res.query(b),
                                mres.query(b))
        flips, band, across = flips + f, band + nb, across + na
    print(f"(d) mesh bf16 batch (B={BATCH}) against the unsharded bf16 "
          f"batch: β within beta_err_tol per query; mask flips {flips} "
          f"({band} in the band, {across} across); bf16-phase iterations "
          f"{sum(s.solver_lo_iters for s in mres.stats)} of "
          f"{sum(s.solver_iters for s in mres.stats)}; fista_step_bf16 "
          f"{got['mesh batch']['fista_step_bf16']}; walls "
          f"{walls['mesh batch']:.2f} s against {walls['batch']:.2f} s")
    main = dict(got["mesh bf16 screen"])
    main_solve = dict(got["mesh fista"])
    del msess, plain, arms

    # (e) the CLI on its own one-rank NCCL group
    ops.reset_counts()
    t0 = time.perf_counter()
    res = solve_cli.main(["--n", str(n), "--p", str(p), "--nnz", "16",
                          "--no-x64", "--num-lambdas", "20", "--mesh", "1x1",
                          "--screen-dtype", "bfloat16",
                          "--solve-dtype", "bfloat16"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(ops, ("screen_matvec_bf16", "fista_step_bf16"))
    mesh_total.update(launches)
    live = bf16_live(res, "solve --mesh 1x1")
    f32 = solved["result"]
    Xs, ys, _ = lasso_problem(n, p, nnz=16, dtype=np.float32)
    Xs64 = torch.as_tensor(Xs, dtype=torch.float64, device=DEVICE)
    flips, band, across = solve_flips(torch, Xs64, ys, f32, res)
    err = float(np.abs(res.betas - f32.betas).max())
    print(f"(e) solve --mesh 1x1 --screen-dtype bfloat16 --solve-dtype "
          f"bfloat16 (20 λ, tol 1e-8): wall {wall:.2f} s; mask flips "
          f"against phase 12's float32 solve {flips} ({band} in the band, "
          f"{across} across); max|dbeta| {err:.3g} (beta_err_tol at 1e-8 "
          f"{beta_err_tol(ys, 1e-8):.3g}); every screened step bf16 "
          f"{all(s.screen_dtype_effective == 'bfloat16' for s in live)}; "
          f"bf16-phase iterations {sum(s.solver_lo_iters for s in live)} "
          f"of {sum(s.solver_iters for s in live)}; launches "
          f"screen_matvec_bf16 {launches['screen_matvec_bf16']}, "
          f"fista_step_bf16 {launches['fista_step_bf16']}")
    assert err <= beta_err_tol(ys, 1e-8), err
    assert all(s.screen_dtype_effective == "bfloat16" for s in live)
    return {"screen": main, "solve": main_solve, "total": dict(mesh_total),
            "cli": dict(launches)}


CHURN = 0.05        # benchmarks/bench_update.py's CHURN_FRAC
APPEND = 64         # the append round's columns
# the λ of each EDPP path that holds an update to its cold refit (and of
# the mesh rounds'), and the solver's iterations a step on both (the two
# paths run the same solves on bit-identical arrays): cut from 100 and
# 5 000 to keep the smoke within half its limit when phase 24 came
UPDATE_LAMBDAS = 20
UPDATE_MAX_ITER = 500


def edited(Xh: np.ndarray, drop, add) -> np.ndarray:
    """The update layout rule on the host (``repro_torch.core.update``):
    adds overwrite the first dropped slots, residual drops compact,
    residual adds append."""
    d = (np.unique(np.asarray(drop, dtype=np.int64)) if drop is not None
         else np.zeros(0, np.int64))
    a = (add if add is not None
         else np.zeros((Xh.shape[0], 0), np.float32))
    k = min(a.shape[1], d.size)
    Xp = Xh.copy()
    if k:
        Xp[:, d[:k]] = a[:, :k]
    keep = np.setdiff1d(np.arange(Xh.shape[1]), d[k:])
    return np.concatenate([Xp[:, keep], a[:, k:]], axis=1)


def refit_contract(torch, sess, ws, X_ed, Y, y, cold_state=None) -> dict:
    """The oracle-refit contract of one update at full width: the
    session's geometry and live workspace against a cold fit of X_ed
    (timed: fit, bf16 copy, its bound and the workspace attach, ended in
    a sync), bit for bit, then an ``UPDATE_LAMBDAS``-λ EDPP path of each
    after
    ``reset_solver_cache()``: masks bit for bit, β within beta_err_tol.
    Returns the readings."""
    from repro_torch import LassoSession, PathConfig, SolveSpec
    from repro_torch.core import PathWorkspace
    cfg = PathConfig(solve=SolveSpec(tol=1e-6, max_iter=UPDATE_MAX_ITER))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = LassoSession.fit(X_ed, config=cfg, device=DEVICE)
    cg = cold.geometry
    cg.screen_copy(torch.bfloat16)
    cg.screen_err(torch.bfloat16)
    cws = PathWorkspace(None, torch.as_tensor(Y, device=DEVICE), geometry=cg)
    torch.cuda.synchronize()
    refit_s = time.perf_counter() - t0
    g = sess.geometry
    arrays = {
        "X": torch.equal(g.X, cg.X), "sumsq": torch.equal(g.sumsq, cg.sumsq),
        "col_norms": torch.equal(g.col_norms, cg.col_norms),
        "bf16": torch.equal(g.screen_copy(torch.bfloat16),
                            cg.screen_copy(torch.bfloat16)),
        "err": torch.equal(g.screen_err(torch.bfloat16),
                           cg.screen_err(torch.bfloat16)),
        "abs_xty": torch.equal(ws.abs_xty, cws.abs_xty),
        "argmax": np.array_equal(ws.istar, cws.istar),
        "lam_max": np.array_equal(ws.lam_max, cws.lam_max),
        "X_host": np.array_equal(g.X.cpu().numpy(), X_ed)}
    sess.reset_solver_cache()
    t0 = time.perf_counter()
    ru = sess.path(y, num_lambdas=UPDATE_LAMBDAS, config=cfg)
    rc = cold.path(y, num_lambdas=UPDATE_LAMBDAS, config=cfg)
    torch.cuda.synchronize()
    err = float(np.abs(ru.betas - rc.betas).max())
    out = {"arrays": arrays, "masks": np.array_equal(ru.masks, rc.masks),
           "dbeta": err, "refit_s": refit_s,
           "paths_s": time.perf_counter() - t0,
           "versions": sorted({s.geometry_version for s in ru.stats})}
    assert all(arrays.values()), arrays
    assert out["masks"] and err <= beta_err_tol(y, 1e-6), (out, err)
    return out


def update_phase(torch, X, y) -> dict:
    """Phase 18, dictionary updates at 784 × 50 000 (see the module doc).
    Returns the launches of the update calls and the readings."""
    import collections

    from repro_torch import LassoSession, PathConfig, SolveSpec
    from repro_torch.core import PathWorkspace
    from repro_torch.kernels import ops
    n, p = X.shape
    rng = np.random.default_rng(18)
    Y = batch_from(X, y, BATCH, seed=18)
    c = int(CHURN * p)
    cfg = PathConfig(solve=SolveSpec(tol=1e-6, max_iter=UPDATE_MAX_ITER))
    sess = LassoSession.fit(X, config=cfg, device=DEVICE)
    sess.geometry.screen_copy(torch.bfloat16)
    sess.geometry.screen_err(torch.bfloat16)
    ws = PathWorkspace(None, torch.as_tensor(Y, device=DEVICE),
                       geometry=sess.geometry)
    sess.path(y, num_lambdas=20, config=cfg)        # warm eigenvectors
    X_ed = X
    launches = collections.Counter()
    rounds = []
    for name in ("balanced 1", "balanced 2", "balanced 3", "append",
                 "drop"):
        t_round = time.perf_counter()
        p_now = X_ed.shape[1]
        if name.startswith("balanced"):
            drop = np.sort(rng.choice(p_now, c, replace=False))
            add = rng.standard_normal((n, c)).astype(np.float32)
        elif name == "append":
            drop, add = None, rng.standard_normal((n, APPEND)).astype(
                np.float32)
        else:
            drop, add = np.sort(rng.choice(p_now, APPEND,
                                           replace=False)), None
        ops.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sess.update(add=add, drop=drop, workspaces=[ws])
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        got = counted(ops, ("edpp_screen_scores", "screen_matvec"))
        launches.update(got)
        X_ed = edited(X_ed, drop, add)
        r = refit_contract(torch, sess, ws, X_ed, Y, y)
        r.update(name=name, update_s=update_s, p=rep.p,
                 rescans=rep.argmax_rescans, launches=dict(
                     (k, v) for k, v in got.items() if v))
        rounds.append(r)
        print(f"  {name:<10} p {rep.p}: update {update_s * 1e3:.2f} ms, "
              f"cold refit {r['refit_s'] * 1e3:.2f} ms (ratio "
              f"{update_s / r['refit_s']:.3f}); arrays bit for bit "
              f"{all(r['arrays'].values())}; {UPDATE_LAMBDAS}-λ masks bit "
              f"for bit {r['masks']}, max|dbeta| {r['dbeta']:.3g}; argmax "
              f"rescans "
              f"{rep.argmax_rescans}; geometry_version {r['versions']}; "
              f"launches {r['launches']}; the two paths {r['paths_s']:.2f} "
              f"s, the round {time.perf_counter() - t_round:.2f} s",
              flush=True)
        assert r["versions"] == [rep.version]
    eig = sess.eig_cache_stats
    print(f"  eig_cache_stats {eig}")
    del sess, ws

    # the (1, 1) mesh: a balanced and a shape-changing edit against the
    # unsharded update
    mesh_rounds = []
    with nccl_world(torch) as mesh:
        msess = LassoSession.fit(X, mesh=mesh, config=cfg, device=DEVICE)
        usess = LassoSession.fit(X, config=cfg, device=DEVICE)
        for s in (msess, usess):
            s.geometry.screen_err(torch.bfloat16)
        for name, drop, add in (
                ("balanced", np.sort(rng.choice(p, c, replace=False)),
                 rng.standard_normal((n, c)).astype(np.float32)),
                ("mixed", np.sort(rng.choice(p, APPEND, replace=False)),
                 rng.standard_normal((n, 2 * APPEND)).astype(np.float32))):
            ops.reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            msess.update(add=add, drop=drop)
            torch.cuda.synchronize()
            mesh_s = time.perf_counter() - t0
            got = counted(ops, ("edpp_screen_scores",))
            launches.update(got)
            usess.update(add=add, drop=drop)
            gm, gu = msess.geometry, usess.geometry
            same = all(torch.equal(a, b) for a, b in (
                (gm.X, gu.X), (gm.sumsq, gu.sumsq),
                (gm.col_norms, gu.col_norms),
                (gm.screen_copy(torch.bfloat16),
                 gu.screen_copy(torch.bfloat16)),
                (gm.screen_err(torch.bfloat16),
                 gu.screen_err(torch.bfloat16))))
            for s in (msess, usess):
                s.reset_solver_cache()
            rm = msess.path(y, num_lambdas=UPDATE_LAMBDAS, config=cfg)
            ru = usess.path(y, num_lambdas=UPDATE_LAMBDAS, config=cfg)
            masks = np.array_equal(rm.masks, ru.masks)
            dbeta = float(np.abs(rm.betas - ru.betas).max())
            moved = gm.last_update_bytes
            mesh_rounds.append({"name": name, "update_s": mesh_s,
                                "bytes_moved": moved, "arrays": same,
                                "masks": masks, "dbeta": dbeta})
            print(f"  mesh {name:<8} p {msess.shape[1]}: update "
                  f"{mesh_s * 1e3:.2f} ms, {moved / 1e6:.1f} MB received "
                  f"in the relayout's all-gathers; arrays bit for bit the "
                  f"unsharded update's {same}; {UPDATE_LAMBDAS}-λ masks bit "
                  f"for bit {masks}, max|dbeta| {dbeta:.3g}", flush=True)
            assert same and masks and dbeta <= beta_err_tol(y, 1e-6)
        del msess, usess
    return {"launches": dict(launches), "rounds": rounds,
            "mesh": mesh_rounds, "eig": eig}


def check_wide_fused(torch, kernels, ref, n: int, p: int, c: int, seed: int,
                     floor_ms: float, ptxas: dict) -> dict:
    """The fused pass over an update's added block (n, c) launched with
    ``wide_p=p``: its ‖x_j‖² (the fit's zero centre) and scores (a random
    centre, ρ = 0.37) bit for bit those of the pass over the whole (n, p)
    X at the block's columns, then the row of :func:`check_kernel` for
    the block against its plain version."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(n, p, generator=g, device="cuda")
    cols = torch.randperm(p, generator=g, device="cuda")[:c].sort().values
    blk = X[:, cols].contiguous()
    zero = torch.zeros(n, device="cuda")
    cen = torch.randn(n, generator=g, device="cuda")
    same = []
    for centre in (zero, cen):
        sc_full, ss_full = kernels.edpp_screen_scores(X, centre, 0.37)
        sc_blk, ss_blk = kernels.edpp_screen_scores(blk, centre, 0.37,
                                                    wide_p=p)
        same.append(torch.equal(ss_blk, ss_full[cols])
                    and torch.equal(sc_blk, sc_full[cols]))
    dots = torch.equal(kernels.screen_matvec(blk, cen, wide_p=p),
                       kernels.screen_matvec(X, cen)[cols])
    own = kernels.edpp_screen_scores(blk, zero, 0.0)[1]
    print(f"  wide plan: edpp_screen_scores on {n}x{c} columns of "
          f"{n}x{p} with wide_p={p}: sumsq and scores bit for bit the full "
          f"pass's {same}; screen_matvec dots {dots}; the block's own plan "
          f"gives the same sumsq {torch.equal(own, ss_full[cols])}",
          flush=True)
    assert all(same) and dots
    del X, blk
    row = check_kernel(torch, kernels, ref, "edpp_screen_scores", n, c, 1,
                       seed=seed + 1, floor_ms=floor_ms, ptxas=ptxas,
                       wide_p=p)
    row.update(bitwise=all(same) and dots)
    return row


def check_wide_group(torch, kernels, ref, n: int, p: int, m: int,
                     seed: int, ptxas: dict, parts: int = 2,
                     must_differ: bool = False) -> dict:
    """The group pass on a contiguous copy of the first of ``parts``
    column blocks of an (n, p) X (a rank's block of a 1 × parts mesh)
    launched with ``wide_p=p``: its scores bit for bit the full pass's at
    those groups; beside it the block's own plan and whether that plan's
    bits differ (with ``must_differ``, the own plan must split the rows
    over another cluster and give other bits: else the row could not
    tell a ``wide_p`` that was ignored); then the row of
    :func:`check_group` for the block (time against its plain version,
    bound, ``c @ X`` yardstick), timed with the wide plan."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.randn(n, p, generator=g, device="cuda")
    c = torch.randn(n, generator=g, device="cuda")
    half = p // parts
    blk = X[:, :half].contiguous()
    full = kernels.group_screen_scores(X, c, m)[:half // m]
    got = kernels.group_screen_scores(blk, c, m, wide_p=p)
    own = kernels.group_screen_scores(blk, c, m)
    bitwise = torch.equal(got, full)
    own_same = torch.equal(own, full)
    gs = kernels.group_screen
    wide_pl = gs.group_plan_for(blk, m, p)
    own_pl = gs.group_plan_for(blk, m)
    out_p = ref.group_screen_ref(blk, c, m)
    torch.cuda.synchronize()
    err = float((got - out_p).abs().max())
    tol = 2e-5 * max(1.0, float(out_p.abs().max()))
    ms = event_ms(torch, lambda: kernels.group_screen_scores(
        blk, c, m, wide_p=p))
    plain_ms = event_ms(torch, lambda: ref.group_screen_ref(blk, c, m))
    matmul_ms = event_ms(torch, lambda: torch.matmul(c, blk))
    bound_ms, bound_by = group_bound(n, half, m)

    def plan(pl):
        return (f"grid={pl.grid} cluster={pl.split} vec={pl.vec} "
                f"tile={pl.tile} stage_rows={pl.stage_rows}")

    row = {"op": "group_screen_scores", "n": n, "p": half, "wide_p": p,
           "m": m, "max_abs_err": err, "tol": tol, "ms": ms,
           "plain_ms": plain_ms, "matmul_ms": matmul_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "bitwise": bitwise,
           "own_plan_same_bits": own_same, "wide_plan": plan(wide_pl),
           "own_plan": plan(own_pl)}
    print(f"  wide plan: group_screen_scores on {n}x{half} (the first "
          f"1/{parts} of {n}x{p}, m={m}) with wide_p={p}: scores bit for "
          f"bit the full pass's {bitwise}; max_abs_err={err:.3g} (tol "
          f"{tol:.3g}) "
          f"ms={ms:.4f} plain_ms={plain_ms:.4f} matmul_ms={matmul_ms:.4f} "
          f"bound_ms={bound_ms:.4f} ({bound_by}) {bound_ms / ms:.0%} of "
          f"bound\n      wide plan {plan(wide_pl)}; the block's own plan "
          f"{plan(own_pl)}, its bits the full pass's {own_same}; "
          f"{colpass_ptxas(ptxas, 'group_screen_scores', 1, wide_pl.vec)}",
          flush=True)
    if not (bitwise and err <= tol):
        raise AssertionError(f"wide group pass {n}x{half} of {p}: bits "
                             f"{bitwise}, error {err} (tol {tol})")
    if must_differ and (own_pl.split == wide_pl.split or own_same):
        raise AssertionError(f"wide group pass {n}x{half} of {p}: the "
                             f"block's own plan {plan(own_pl)} splits the "
                             f"rows as the wide plan does or gave its "
                             f"bits ({own_same}); the row tests nothing")
    del X, blk
    torch.cuda.empty_cache()
    return row


ONE_SHOT = (784, 1024)          # phase 19(d): a slice of the main data
ONE_SHOT_GROUP = (250, 2000)    # and of the group design (m = 10)


def group_mesh_phase(torch, group_full: dict, solved: dict, X, y) -> dict:
    """Phase 19, group mesh sessions and the core surface (see the module
    doc): (a) ``fit(X, groups=10, mesh=)`` on a (1, 1) NCCL mesh at the
    full group design, 100 λ, against phase 7's result; (b) ``solve
    --group-size 10 --mesh 1x1`` against phase 12's group solve; (c) a
    (1, 1, 1) ("query", "a", "b") mesh against the (1, 1) mesh at
    784 × 50 000, 20 λ; (d) the one-shot solvers and ``lasso_path``.
    Returns the launches of (a) and (d)."""
    import warnings

    from repro_torch import LassoSession, PathConfig, SolveSpec
    from repro_torch import core
    from repro_torch.core.group_screening import group_spectral_norms
    from repro_torch.kernels import ops
    from repro_torch.launch import solve as solve_cli
    from torch.distributed.device_mesh import init_device_mesh
    out = {}
    Xg, yg, res_g = group_full["X"], group_full["y"], group_full["res"]
    m = GROUP_FULL[2]
    cfg = PathConfig(solve=SolveSpec(tol=1e-6))
    with nccl_world(torch) as mesh:
        # (a) the group mesh session against phase 7's unsharded path
        ops.reset_counts()
        t0 = time.perf_counter()
        sess = LassoSession.fit(Xg, groups=m, mesh=mesh, config=cfg,
                                device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        sess.reset_solver_cache()
        res = sess.path(yg, num_lambdas=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["mesh"] = counted(ops, ("group_screen_scores",))
        same = {
            "masks": np.array_equal(res.masks, res_g.masks),
            "n_discarded": [s.n_discarded for s in res.stats]
            == [s.n_discarded for s in res_g.stats],
            "x_passes": [s.x_passes for s in res.stats]
            == [s.x_passes for s in res_g.stats],
            "bucket": [s.bucket for s in res.stats]
            == [s.bucket for s in res_g.stats],
            "betas": np.array_equal(res.betas, res_g.betas),
            "spec_norms": torch.equal(sess.geometry.spec_norms.cpu(),
                                      group_full["spec"])}
        print(f"(a) group mesh session, (1, 1) NCCL mesh, {Xg.shape[0]} × "
              f"{Xg.shape[1]}, m={m}, 100 λ, tol 1e-6: backend "
              f"{sess.backend_name}; wall {wall:.2f} s (fit {fit_s:.2f} s) "
              f"against phase 7's {group_full['wall']:.2f} s (fit "
              f"{group_full['fit_s']:.2f} s); bit for bit phase 7's: {same}")
        assert sess.backend_name == "shard:cuda" and all(same.values())
        del sess
        # the spectral norms of two blocks against the whole batch's
        Xt = torch.as_tensor(Xg, device=DEVICE)
        half = Xg.shape[1] // 2
        parts = [group_spectral_norms(Xt[:, :half].contiguous(), m),
                 group_spectral_norms(Xt[:, half:].contiguous(), m)]
        one = group_spectral_norms(Xt[:, :m].contiguous(), m)
        full = group_full["spec"].to(DEVICE)
        halves = int((torch.cat(parts) != full).sum())
        print(f"    eigvalsh bits: two blocks of {half // m} groups against "
              f"the whole batch of {Xg.shape[1] // m}: {halves} differ; a "
              f"block of one group (a batch of 1): "
              f"{'the same' if torch.equal(one, full[:1]) else 'other'} "
              f"bits")
        assert halves == 0 and torch.equal(one, full[:1])
        del Xt, parts
        torch.cuda.empty_cache()

        # (c) two feature axes against one, at 784 × 50 000
        axes = init_device_mesh(mesh.device_type, (1, 1, 1),
                                mesh_dim_names=("query", "a", "b"))
        runs = {}
        for name, msh in (("(1, 1)", mesh), ("(1, 1, 1)", axes)):
            ops.reset_counts()
            t0 = time.perf_counter()
            s = LassoSession.fit(X, mesh=msh, config=cfg, device=DEVICE)
            runs[name] = s.path(y, num_lambdas=20, hi_frac=0.95)
            torch.cuda.synchronize()
            launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                                     "fista_step"))
            print(f"(c) {name} mesh, {X.shape[0]} × {X.shape[1]}, 20 λ: "
                  f"backend "
                  f"{s.backend_name}, {time.perf_counter() - t0:.2f} s; "
                  f"launches screen_matvec {launches['screen_matvec']}, "
                  f"fista_step {launches['fista_step']}")
        a, b = runs.values()
        same = (np.array_equal(a.masks, b.masks)
                and np.array_equal(a.betas, b.betas)
                and [(t.n_discarded, t.x_passes, t.bucket) for t in a.stats]
                == [(t.n_discarded, t.x_passes, t.bucket) for t in b.stats])
        print(f"    (1, 1, 1) bit for bit the (1, 1) mesh: {same}")
        assert same

    # (b) the CLI's group mesh run against phase 12's group solve
    n_g, p_g, m_e = GROUP_EXACT
    ops.reset_counts()
    t0 = time.perf_counter()
    res_b = solve_cli.main(["--n", str(n_g), "--p", str(p_g),
                            "--group-size", str(m_e), "--nnz", "200",
                            "--no-x64", "--num-lambdas", "20", "--mesh",
                            "1x1"])
    torch.cuda.synchronize()
    launches = counted(ops, ("group_screen_scores",))
    want = solved["group_result"]
    same = (np.array_equal(res_b.masks, want.masks)
            and np.array_equal(res_b.betas, want.betas))
    print(f"(b) solve --group-size {m_e} --mesh 1x1 ({n_g} × {p_g}, 20 λ): "
          f"{time.perf_counter() - t0:.2f} s; group_screen_scores "
          f"{launches['group_screen_scores']}; bit for bit phase 12's group "
          f"solve {same}")
    assert same

    # (d) the one-shot solvers and the deprecated shim
    n1, p1 = ONE_SHOT
    Xc = torch.as_tensor(np.ascontiguousarray(X[:, :p1]), device=DEVICE)
    lam = 0.3 * float(torch.max(torch.abs(Xc.T @ torch.as_tensor(
        y, device=DEVICE))))
    ops.reset_counts()
    t0 = time.perf_counter()
    fi = core.fista(Xc, y, lam, tol=1e-6)
    torch.cuda.synchronize()
    fi_s = time.perf_counter() - t0
    out["one_shot"] = counted(ops, ("fista_step",))
    assert out["one_shot"]["fista_step"] == fi.iters
    t0 = time.perf_counter()
    cdr = core.cd(Xc, y, lam, tol=1e-6)
    torch.cuda.synchronize()
    cd_s = time.perf_counter() - t0
    err = float((fi.beta - cdr.beta).abs().max())
    tol = beta_err_tol(y, 1e-6)
    ng, pg = ONE_SHOT_GROUP
    Xgs = torch.as_tensor(np.ascontiguousarray(Xg[:ng, :pg]),
                          device=DEVICE)
    ygs = torch.as_tensor(yg[:ng], device=DEVICE)
    glam = 0.3 * float(torch.max(torch.linalg.vector_norm(
        (Xgs.T @ ygs).reshape(-1, m), dim=1)) / np.sqrt(m))
    t0 = time.perf_counter()
    gf = core.group_fista(Xgs, ygs, glam, m, tol=1e-6)
    torch.cuda.synchronize()
    gf_s = time.perf_counter() - t0
    print(f"(d) one-shot at 0.3·λ_max, tol 1e-6: fista {n1} × {p1} "
          f"{fi.iters} iterations ({out['one_shot']['fista_step']} "
          f"fista_step launches) {fi_s:.2f} s, converged "
          f"{bool(fi.converged)}; cd {cdr.iters} epochs {cd_s:.2f} s, "
          f"converged {bool(cdr.converged)}; max|beta_fista - beta_cd| "
          f"{err:.3g} (tol {tol:.3g}); group_fista {ng} × {pg} (m={m}) "
          f"{gf.iters} iterations {gf_s:.2f} s, converged "
          f"{bool(gf.converged)}")
    assert fi.converged and cdr.converged and gf.converged and err <= tol
    assert bool(torch.isfinite(gf.beta).all())
    del Xc, Xgs
    grid = np.linspace(0.95, 0.05, 20) * float(np.abs(X.T @ y).max())
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        shim = core.lasso_path(X, y, grid, cfg, device=DEVICE)
    direct = LassoSession.fit(X, config=cfg, device=DEVICE).path(
        y, grid).squeeze()
    torch.cuda.synchronize()
    warned = any(issubclass(w.category, DeprecationWarning)
                 and "repro_torch.core.lasso_path" in str(w.message)
                 for w in seen)
    same = (np.array_equal(shim.masks, direct.masks)
            and np.array_equal(shim.betas, direct.betas))
    print(f"    lasso_path at 20 λ ({time.perf_counter() - t0:.2f} s, both "
          f"calls): DeprecationWarning {warned}; bit for bit "
          f"LassoSession.fit(X).path(y, grid) {same}")
    assert warned and same
    return out


# Phase 20, the LM stack: yi-9b at its published width (d_model 4096, 32
# heads, kv 4, d_head 128, d_ff 11 008, vocab 64 000, SwiGLU, θ 5e6), its
# depth cut from 48 layers (the f32 masters and two moments of all 48,
# 8.6e9 × 12 B ≈ 103 GB, pass one card's 80 GB)
LM_ARCH = "yi-9b"
# the widths phase 20 holds the config to: d_model, heads, kv heads,
# d_head, d_ff, vocab
LM_WIDTH = (4096, 32, 4, 128, 11008, 64000)
# layers kept of the segment's 48 (4 took the phase 105.5 s on the card,
# 53 s of it the 11.4 GB checkpoint's npz round trip: cut to 3, 9.4 GB)
LM_DEPTH = 3
LM_SEQ = 4096           # train_4k's sequence
LM_BATCH = 4            # train_4k's global batch 256, cut to the phase's time
LM_STEPS = 4            # steps on one fixed batch; (b) resumes the last
# full lr from step 1 (warmup 1): on one fixed batch the loss falls at
# every step for twice the phase's steps at 1e-4; 1e-3 and 5e-4 rose
# again at step 3 (every parameter moves by ±lr on Adam's first steps;
# ``--lm-lr`` reads each of LM_LR_SWEEP's rates)
LM_LR = 1e-4
LM_LR_SWEEP = (1e-3, 5e-4, 2e-4, 1e-4)
LM_PREFILL = 1016       # (c): prefill this many tokens, then decode
LM_DECODE = 8
# (c)'s limits on max|logits_decode − logits_forward| relative to
# max|logits_forward|: in f32 the two differ by the order of f32 sums;
# in bf16 every product's output is rounded to bf16 (8 bits) by other
# kernels for one token than for a sequence, through every layer
LM_DECODE_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
LM_PROBE = 2048         # (e): the probe batch's tokens (one sequence)
BRIDGE_LAMBDAS = 20
BRIDGE_LO_FRAC = 0.02
# examples/prune_ffn.py solves at 1e-10, below what an f32 duality gap
# certifies (its rounding noise is ~1e-7 of ½‖y‖²): the bridge solves both
# arms at the exactness phases' 1e-6
BRIDGE_TOL = 1e-6


def lm_example():
    """``examples/prune_ffn_torch.py`` as a module: the bridge's H and y,
    its path and its table."""
    import importlib.util
    path = os.path.join(HERE, "examples", "prune_ffn_torch.py")
    spec = importlib.util.spec_from_file_location("prune_ffn_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_tree(a, b) -> bool:
    """Whether two trees (dicts, lists, NamedTuples; numpy or tensor
    leaves, None) hold equal arrays under the same keys."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y)
                                        for x, y in zip(a, b))
    if a is None or b is None:
        return a is None and b is None
    def as_np(x):
        if not hasattr(x, "numpy"):
            return np.asarray(x)
        x = x.detach().cpu()
        if str(x.dtype) == "torch.bfloat16":     # numpy has no bfloat16
            import torch
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()

    x, y = as_np(a), as_np(b)
    bits = lambda v: v.view(np.int16) if v.dtype.kind == "V" else v
    return x.dtype == y.dtype and np.array_equal(bits(x), bits(y))


def lm_config():
    """Phase 20's config: ``LM_ARCH`` at full width, its segment cut to
    ``LM_DEPTH`` layers; and the uncut segment."""
    import dataclasses

    from repro_torch import configs
    full = configs.get_config(LM_ARCH)
    seg = full.segments[0]
    return dataclasses.replace(full, segments=(
        dataclasses.replace(seg, repeat=LM_DEPTH),)), seg


def lm_lr_sweep(torch) -> dict:
    """``--lm-lr``: phase 20(a)'s steps on its fixed batch, from the same
    initial state, at each rate of ``LM_LR_SWEEP`` (warmup 1), for twice
    ``LM_STEPS`` steps each. Returns {rate: losses}."""
    from repro_torch.data import SyntheticLM, to_device
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST

    cfg, _ = lm_config()
    dev = torch.device(DEVICE)
    batch = to_device(SyntheticLM(vocab=cfg.vocab, seq=LM_SEQ,
                                  global_batch=LM_BATCH).host_batch(0), dev)
    out = {}
    for lr in LM_LR_SWEEP:
        tc = ST.TrainConfig(opt=adamw.OptConfig(lr=lr, warmup_steps=1,
                                                total_steps=100))
        state, _ = ST.init_state(0, cfg, tc, device=dev)
        step = ST.make_train_step(cfg, tc)
        losses = []
        for _ in range(2 * LM_STEPS):
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        falls = all(b < a for a, b in zip(losses, losses[1:]))
        print(f"  lr {lr:g}: losses {losses}; falls at every step: "
              f"{falls}", flush=True)
        assert np.isfinite(losses).all(), (lr, losses)
        out[lr] = losses
        del state, step
        torch.cuda.empty_cache()
    return out


def stop_all(procs) -> None:
    """Kill and reap each of ``procs`` (``subprocess.Popen``) still
    running."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_cli(arch: str, tmp: str) -> tuple:
    """``python -m repro_torch.launch.train --arch <arch> --tiny --steps
    10`` started on the card, as a user runs it. Returns what
    :func:`finish_cli` takes."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            arch, "--tiny", "--steps", "10"]
    if DEVICE != "cuda":
        argv += ["--device", DEVICE]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=tmp,
                            env=dict(os.environ, PYTHONPATH=os.path.join(
                                HERE, "src")))
    return argv, proc, time.perf_counter()


def finish_cli(label: str, run: tuple) -> str:
    """Wait for a :func:`start_cli` run: it exits 0 after its 10 steps.
    Prints its output; returns its stdout."""
    argv, proc, t0 = run
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        stop_all([proc])
    print(f"({label}) {' '.join(argv[1:])}: exit {proc.returncode}, "
          f"{time.perf_counter() - t0:.2f} s from its start")
    for line in out.splitlines():
        print(f"    {line}")
    assert proc.returncode == 0, err[-3000:]
    assert "10 steps in" in out
    return out


def lm_phase(torch, tmp: str, cli=None) -> dict:
    """Phase 20, the LM stack at yi-9b's width (see the module doc): (a)
    train steps on a fixed batch, (b) a checkpoint round trip and the
    resumed step, (c) prefill + decode against the full forward, (d)
    ``python -m repro_torch.launch.train`` on the card, (e) the FFN-
    pruning bridge on (a)'s model. Returns (e)'s launches and the
    readings."""
    import warnings

    from repro_torch.checkpoint import restore, save
    from repro_torch.convert import (train_state_from_reference,
                                     train_state_to_reference)
    from repro_torch.data import SyntheticLM, to_device
    from repro_torch.kernels import ops
    from repro_torch.models import model as M, pad_caches
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST

    cfg, seg = lm_config()
    a, f = seg.blocks[0].attn, seg.blocks[0].ffn
    print(f"(a) {LM_ARCH} at full width: d_model {cfg.d_model}, heads "
          f"{a.n_heads}, kv {a.n_kv_heads}, d_head {a.d_head}, d_ff {f.d_ff} "
          f"({f.kind}), vocab {cfg.vocab}, θ {a.rope_theta:g}; depth L = "
          f"{LM_DEPTH} of {seg.repeat}; seq {LM_SEQ}, batch {LM_BATCH} (of "
          f"train_4k's 256); bf16 compute, AdamW lr {LM_LR:g}", flush=True)
    assert (cfg.d_model, a.n_heads, a.n_kv_heads, a.d_head, f.d_ff,
            cfg.vocab) == LM_WIDTH
    tc = ST.TrainConfig(opt=adamw.OptConfig(lr=LM_LR, warmup_steps=1,
                                            total_steps=100))
    dev = torch.device(DEVICE)
    readings = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = ST.init_state(0, cfg, tc, device=dev)
    torch.cuda.synchronize()
    n_params = state.params.n_params()
    print(f"  {n_params:,} parameters; init {time.perf_counter() - t0:.2f} "
          f"s", flush=True)
    src = SyntheticLM(vocab=cfg.vocab, seq=LM_SEQ, global_batch=LM_BATCH)
    batch = to_device(src.host_batch(0), dev)
    step = ST.make_train_step(cfg, tc)
    losses, walls = [], []

    def take_step(state):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))          # syncs
        walls.append(time.perf_counter() - t0)
        print(f"  step {len(losses) - 1}: loss {losses[-1]:.6f} grad_norm "
              f"{float(metrics['grad_norm']):.4f} lr "
              f"{float(metrics['lr']):.2e} wall {walls[-1]:.3f} s",
              flush=True)
        return state

    for _ in range(LM_STEPS - 1):
        state = take_step(state)
    # (b) save before the last step, take it, restore, take it again
    t0 = time.perf_counter()
    saved = train_state_to_reference(state)
    ckpt = os.path.join(tmp, "lm_ckpt")
    save(ckpt, LM_STEPS - 1, saved)
    save_s = time.perf_counter() - t0
    state = take_step(state)
    tokens = LM_BATCH * LM_SEQ
    tok_s = tokens * (LM_STEPS - 1) / sum(walls[1:])
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {losses}; {tok_s:,.0f} tokens/s over steps 1.."
          f"{LM_STEPS - 1} ({tokens} tokens a step); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB; L = {LM_DEPTH}", flush=True)
    assert np.isfinite(losses).all(), losses
    assert all(b < a_ for a_, b in zip(losses, losses[1:])), losses
    readings.update(params=n_params, losses=list(losses), step_s=list(walls),
                    tokens_per_s=tok_s, peak_gib=peak / 2**30,
                    depth=LM_DEPTH, batch=LM_BATCH, seq=LM_SEQ)
    del state
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tree, _ = restore(ckpt, LM_STEPS - 1, saved, device="cpu")
    equal = same_tree(saved, tree)
    state = train_state_from_reference(tree, cfg, device=dev)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del saved, tree
    uninterrupted = losses[-1]
    state = take_step(state)
    resumed = losses.pop()
    walls.pop()
    print(f"(b) checkpoint of the {n_params:,}-parameter state (params, "
          f"both moments, steps): save {save_s:.2f} s, restore "
          f"{restore_s:.2f} s, restored leaves equal the saved ones "
          f"{equal}; the resumed step's loss {resumed:.6f} against the "
          f"uninterrupted {uninterrupted:.6f} (bit for bit "
          f"{resumed == uninterrupted})", flush=True)
    assert equal and int(state.step) == LM_STEPS
    assert abs(resumed - uninterrupted) <= 1e-6 * abs(uninterrupted)
    readings.update(save_s=save_s, restore_s=restore_s,
                    resumed_bitwise=resumed == uninterrupted)

    # (c) prefill, then decode, against the full forward on the same tokens
    model = state.params
    toks = torch.from_numpy(np.random.default_rng(20).integers(
        0, cfg.vocab, (1, LM_PREFILL + LM_DECODE), dtype=np.int32)).to(dev)
    for name, cdt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        tcd = ST.TrainConfig(compute_dtype=name)
        prefill = ST.make_prefill_step(cfg, tcd)
        decode = ST.make_decode_step(cfg, tcd)
        t0 = time.perf_counter()
        with torch.no_grad():
            tree = model.tree(cast=cdt)
            x, pos, _ = M._embed_inputs(tree, cfg, {"tokens": toks}, cdt)
            h, _ = M.backbone(tree, cfg, x, pos)
            want = M.logits_for(tree, cfg, h[:, LM_PREFILL - 1:])
            del tree, x, h
        last, caches = prefill(model, {"tokens": toks[:, :LM_PREFILL]})
        caches = pad_caches(caches, LM_PREFILL + LM_DECODE)
        outs = [last[:, 0]]
        for t in range(LM_PREFILL, LM_PREFILL + LM_DECODE):
            lg, caches = decode(model, toks[:, t:t + 1], caches, t)
            outs.append(lg[:, 0])
        got = torch.stack(outs, 1)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        torch.cuda.synchronize()
        print(f"(c) {name}: prefill {LM_PREFILL} tokens then decode "
              f"{LM_DECODE}: max|Δlogits| {err:.4g} of max|logits| "
              f"{scale:.4g} ({err / scale:.3g}; limit "
              f"{LM_DECODE_TOL[name]:g}); top-1 agree "
              f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/"
              f"{LM_DECODE + 1}; {time.perf_counter() - t0:.2f} s",
              flush=True)
        assert bool(torch.isfinite(got).all())
        assert err <= LM_DECODE_TOL[name] * scale, (name, err, scale)
        readings[f"decode_rel_err_{name}"] = err / scale
        del caches, got, want
    torch.cuda.empty_cache()

    # (d) the entry point, as a user runs it, on the card (started with
    # the phase, or by the caller before it)
    finish_cli("d", cli or start_cli(LM_ARCH, tmp))

    # (e) the FFN-pruning bridge on (a)'s model at full width
    ex = lm_example()
    probe = SyntheticLM(vocab=cfg.vocab, seq=LM_PROBE,
                        global_batch=1).host_batch(99)
    H, y = ex.ffn_regression(model, to_device(probe, dev)["tokens"])
    del model, state
    torch.cuda.empty_cache()
    arms = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for rule in ("edpp", "none"):
            ops.reset_counts()
            t0 = time.perf_counter()
            grid, lmax, res = ex.prune_path(
                H, y, num=BRIDGE_LAMBDAS, lo_frac=BRIDGE_LO_FRAC, rule=rule,
                solver_tol=BRIDGE_TOL, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counted(ops, ("group_screen_scores",)
                               if rule == "edpp" else ())
            st = res.stats
            print(f"(e) {rule}: {wall:.2f} s; solver iterations "
                  f"{sum(s.solver_iters for s in st)}, steps at max_iter "
                  f"{sum(s.solver_iters >= 5000 for s in st)}; discards "
                  f"{[s.n_discarded for s in st]}", flush=True)
            arms[rule] = (res, launches, wall)
    res, launches, wall = arms["edpp"]
    res_none = arms["none"][0]
    screens = sum(1 for s in res.stats if s.screen_backend)
    b_n = res_none.betas
    scale = float(np.abs(b_n).max())
    unsafe = int((res.masks & (np.abs(b_n) > 1e-6 * scale)).sum())
    err = float(np.abs(res.betas - b_n).max())
    yn = y.cpu().numpy()
    print(f"  H {tuple(H.shape)} (probe tokens × neurons), m = 1, "
          f"{BRIDGE_LAMBDAS} λ from λ_max {lmax:.6g} to {BRIDGE_LO_FRAC:g}"
          f"·λ_max, tol {BRIDGE_TOL:g} (the example's 1e-10 is below f32 "
          f"noise); group_screen_scores launches "
          f"{launches['group_screen_scores']} for {screens} screens and the "
          f"λ̄_max pass; unsafe discards {unsafe}; max|β_edpp − β_none| "
          f"{err:.3g} (limits {GROUP_REL_TOL:g}·max|β_none| = "
          f"{GROUP_REL_TOL * scale:.3g} and beta_err_tol "
          f"{beta_err_tol(yn, BRIDGE_TOL):.3g})")
    print("\n".join(ex.table(H, y, grid, lmax, res)), flush=True)
    assert launches["group_screen_scores"] == screens + 1
    assert unsafe == 0 and err <= GROUP_REL_TOL * scale
    assert err <= beta_err_tol(yn, BRIDGE_TOL)
    readings.update(bridge_s={r: arms[r][2] for r in arms},
                    bridge_err=err, bridge_screens=screens)
    del H, y
    torch.cuda.empty_cache()
    return {"bridge": launches, "readings": readings}


# Phase 21, MoE and MLA: deepseek-v2-lite-16b at its published width
# (d_model 2048, 16 heads, MLA r 512, d_nope 128, d_rope 64, d_v 128;
# 64 routed experts of 1 408, top-6, 2 shared; layer 0 dense, d_ff
# 10 944; vocab 102 400; capacity 1.25 in groups of 128), its depth cut
# from 27 layers to layer 0 and 2 MoE layers (1.46e9 parameters, 17.5 GB
# of f32 masters and moments; uncut 15.5e9 and 186 GB pass one card)
MOE_ARCH = "deepseek-v2-lite-16b"
# d_model, heads, r, d_nope, d_rope, d_v, routed, d_expert, top_k,
# shared, dense d_ff, vocab, capacity_factor, group_size
MOE_WIDTH = (2048, 16, 512, 128, 64, 128, 64, 1408, 6, 2, 10944, 102400,
             1.25, 128)
MOE_DEPTH = 2           # MoE layers kept of 26, after the dense layer 0
# (b)'s capacity: cap = int(128·6/64·16) = 192 ≥ g = 128 in a forward
# group, and 1 slot for a decode group of one token, so nothing drops and
# a token routes alike in both paths (n_routed/top_k would give 127)
MOE_DROPLESS = 16.0
MOE_CLI_ARCH = "moonshot-v1-16b-a3b"
MOE_PHASE = (f"MoE and MLA: {MOE_ARCH} at full width, 1 dense + {MOE_DEPTH} "
             f"MoE layers, seq {LM_SEQ}, batch {LM_BATCH}; {MOE_CLI_ARCH} "
             f"--tiny through launch.train")


def moe_config(capacity: float | None = None):
    """Phase 21's config: ``MOE_ARCH`` at full width, its MoE segment cut
    to ``MOE_DEPTH`` layers (and every MoE block's ``capacity_factor`` set
    to ``capacity``); and the uncut MoE segment."""
    import dataclasses

    from repro_torch import configs
    full = configs.get_config(MOE_ARCH)
    dense, moe = full.segments
    seg = dataclasses.replace(moe, repeat=MOE_DEPTH)
    if capacity is not None:
        blk = moe.blocks[0]
        seg = dataclasses.replace(seg, blocks=(dataclasses.replace(
            blk, moe=dataclasses.replace(blk.moe,
                                         capacity_factor=capacity)),))
    return dataclasses.replace(full, segments=(dense, seg)), moe


@contextlib.contextmanager
def moe_routes():
    """Record every ``layers.moe_route`` result while the block runs (the
    MoE FFN's own routing call, on the layer's input)."""
    from repro_torch.models import layers as L
    out, orig = [], L.moe_route

    def wrapped(params, spec, x):
        r = orig(params, spec, x)
        out.append(r)
        return r

    L.moe_route = wrapped
    try:
        yield out
    finally:
        L.moe_route = orig


def moe_phase(torch, tmp: str, cli=None) -> None:
    """Phase 21, MoE and MLA at deepseek-v2-lite's width (see the module
    doc): (a) train steps on a fixed batch with each MoE layer's drop
    share at step 0, (b) prefill + decode against the full forward at the
    dropless capacity, (c) ``python -m repro_torch.launch.train --arch
    moonshot-v1-16b-a3b --tiny`` on the card. Launches no kernel of the
    six."""
    from repro_torch.data import SyntheticLM, to_device
    from repro_torch.kernels import ops
    from repro_torch.models import model as M, pad_caches
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST

    before = dict(ops.launch_counts())
    cfg, uncut = moe_config()
    dense, seg = cfg.segments
    m, e, f = seg.blocks[0].mla, seg.blocks[0].moe, dense.blocks[0].ffn
    width = (cfg.d_model, m.n_heads, m.kv_lora_rank, m.d_nope, m.d_rope,
             m.d_v, e.n_routed, e.d_expert, e.top_k, e.n_shared, f.d_ff,
             cfg.vocab, e.capacity_factor, e.group_size)
    print(f"(a) {MOE_ARCH} at full width: d_model {cfg.d_model}, heads "
          f"{m.n_heads}, MLA r {m.kv_lora_rank} d_nope {m.d_nope} d_rope "
          f"{m.d_rope} d_v {m.d_v}; {e.n_routed} routed experts of "
          f"{e.d_expert}, top-{e.top_k}, {e.n_shared} shared; dense layer 0 "
          f"d_ff {f.d_ff}; vocab {cfg.vocab}; capacity {e.capacity_factor} "
          f"in groups of {e.group_size}; depth {dense.repeat} dense + "
          f"{MOE_DEPTH} MoE of {uncut.repeat}; seq {LM_SEQ}, batch "
          f"{LM_BATCH}; bf16 compute, AdamW lr {LM_LR:g}", flush=True)
    assert width == MOE_WIDTH, width
    tc = ST.TrainConfig(opt=adamw.OptConfig(lr=LM_LR, warmup_steps=1,
                                            total_steps=100))
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = ST.init_state(0, cfg, tc, device=dev)
    torch.cuda.synchronize()
    print(f"  {state.params.n_params():,} parameters; init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    batch = to_device(SyntheticLM(vocab=cfg.vocab, seq=LM_SEQ,
                                  global_batch=LM_BATCH).host_batch(0), dev)
    # step 0's routing: the forward the step takes (its cast tree, its
    # batch) without gradients, each MoE layer's own routing call
    with torch.no_grad(), moe_routes() as routes:
        M.forward_loss(state.params.tree(cast=torch.bfloat16), cfg, batch)
    drops = []
    for r in routes:
        kept = r.keep.reshape(-1, e.top_k)[:r.tokens]
        drops.append(1.0 - float(kept.float().mean()))
    print(f"  step 0: share of (token, choice) pairs over capacity per MoE "
          f"layer {[round(x, 6) for x in drops]} (cap {routes[0].cap} slots "
          f"an expert in {tuple(routes[0].topi.shape[:2])} groups × tokens)",
          flush=True)
    assert len(drops) == MOE_DEPTH
    del routes
    step = ST.make_train_step(cfg, tc)
    losses, walls = [], []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))          # syncs
        walls.append(time.perf_counter() - t0)
        print(f"  step {len(losses) - 1}: loss {losses[-1]:.6f} grad_norm "
              f"{float(metrics['grad_norm']):.4f} wall {walls[-1]:.3f} s",
              flush=True)
    tokens = LM_BATCH * LM_SEQ
    tok_s = tokens * (LM_STEPS - 1) / sum(walls[1:])
    peak = torch.cuda.max_memory_allocated()
    print(f"  losses {losses}; {tok_s:,.0f} tokens/s over steps 1.."
          f"{LM_STEPS - 1} ({tokens} tokens a step); max_memory_allocated "
          f"{peak / 2**30:.2f} GiB", flush=True)
    assert np.isfinite(losses).all(), losses
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    del batch, metrics

    # (b) prefill, then decode, against the full forward at the dropless
    # capacity, on (a)'s trained model
    model = state.params
    cfg_d, _ = moe_config(MOE_DROPLESS)
    toks = torch.from_numpy(np.random.default_rng(21).integers(
        0, cfg.vocab, (1, LM_PREFILL + LM_DECODE), dtype=np.int32)).to(dev)
    for name, cdt in (("float32", torch.float32),
                      ("bfloat16", torch.bfloat16)):
        tcd = ST.TrainConfig(compute_dtype=name)
        prefill = ST.make_prefill_step(cfg_d, tcd)
        decode = ST.make_decode_step(cfg_d, tcd)
        t0 = time.perf_counter()
        with torch.no_grad(), moe_routes() as fwd_routes:
            tree = model.tree(cast=cdt)
            x, pos, _ = M._embed_inputs(tree, cfg_d, {"tokens": toks}, cdt)
            h, _ = M.backbone(tree, cfg_d, x, pos)
            want = M.logits_for(tree, cfg_d, h[:, LM_PREFILL - 1:])
            del tree, x, h
        last, caches = prefill(model, {"tokens": toks[:, :LM_PREFILL]})
        caches = pad_caches(caches, LM_PREFILL + LM_DECODE)
        outs, dec_routes = [last[:, 0]], []
        for t in range(LM_PREFILL, LM_PREFILL + LM_DECODE):
            with moe_routes() as rs:
                lg, caches = decode(model, toks[:, t:t + 1], caches, t)
            dec_routes.append(rs)
            outs.append(lg[:, 0])
        got = torch.stack(outs, 1)
        scale = float(want.abs().max())
        err = float((got - want).abs().max())
        torch.cuda.synchronize()
        # decoded positions whose expert set differs from the forward's
        differ = []
        for i, rs in enumerate(dec_routes):
            t = LM_PREFILL + i
            for layer, (fr, dr) in enumerate(zip(fwd_routes, rs)):
                a = sorted(fr.topi.reshape(-1, e.top_k)[t].tolist())
                b = sorted(dr.topi.reshape(-1, e.top_k)[0].tolist())
                if a != b:
                    differ.append((t, layer, a, b))
        dropped = sum(int((~r.keep).reshape(-1, e.top_k)[:r.tokens].sum())
                      for r in fwd_routes + sum(dec_routes, []))
        ok = err <= LM_DECODE_TOL[name] * scale
        print(f"(b) {name}: prefill {LM_PREFILL} tokens then decode "
              f"{LM_DECODE} at capacity {MOE_DROPLESS:g}: max|Δlogits| "
              f"{err:.4g} of max|logits| {scale:.4g} ({err / scale:.3g}; "
              f"limit {LM_DECODE_TOL[name]:g}); top-1 agree "
              f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/"
              f"{LM_DECODE + 1}; pairs dropped {dropped}; decoded "
              f"(position, MoE layer) pairs with another expert set than the "
              f"forward's: {len(differ)} of {LM_DECODE * MOE_DEPTH}; "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        if not ok or name == "bfloat16":
            for t, layer, a, b in differ:
                print(f"    position {t}, MoE layer {layer}: forward {a}, "
                      f"decode {b}")
        assert bool(torch.isfinite(got).all()) and dropped == 0
        assert ok, (name, err, scale)
        del caches, got, want, fwd_routes, dec_routes
    del model, state
    torch.cuda.empty_cache()

    # (c) the entry point, as a user runs it, on the card (started with
    # the phase, or by the caller before it)
    out = finish_cli("c", cli or start_cli(MOE_CLI_ARCH, tmp))
    cli_losses = [float(x) for x in re.findall(r"loss\s+(\S+)", out)]
    assert cli_losses and np.isfinite(cli_losses).all(), cli_losses

    after = dict(ops.launch_counts())
    print(f"  kernel launches before the phase {before}, after {after}: "
          f"equal {after == before}")
    assert after == before


# Phase 22, the recurrent architectures at their published widths and
# full depths: zamba2-1.2b (38 Mamba2 blocks, d_model 2048, d_inner 4096,
# 64 heads of 64, state 64, conv 4, chunk 128; one shared attention + FFN
# block, 32 heads of 64, d_ff 8 192, applied after every 6th Mamba2 block;
# vocab 32 000) and xlstm-350m (21 mLSTM and 3 sLSTM blocks, d_model
# 1 024, 4 heads; vocab 50 304): 1.10e9 and 3.89e8 parameters, 13.3 and
# 4.7 GB of f32 masters and moments. xlstm's depth is cut all the same,
# to its first super-block of 7 mLSTM and 1 sLSTM blocks (``SSM_SUPER``;
# cut when phase 24 came: its sLSTM loops' host time, 92 % of a step,
# took 60–92 s of the smoke's limit at full depth)
SSM_ARCHS = ("zamba2-1.2b", "xlstm-350m")
SSM_SUPER = {"xlstm-350m": 1}      # super-blocks kept, of 3
# the widths and depths of the published configs, which phase 22 holds
# before its cut
SSM_WIDTH = {
    # d_model, Mamba2 blocks, d_state, head_dim, heads, shared-block
    # applications, its heads, d_head and d_ff, vocab
    "zamba2-1.2b": (2048, 38, 64, 64, 64, 6, 32, 64, 8192, 32000),
    # d_model, mLSTM blocks, sLSTM blocks, heads, vocab
    "xlstm-350m": (1024, 21, 3, 4, 50304),
}
# the parameters trained: zamba2 whole, xlstm at its cut depth (its whole
# 388 529 236)
SSM_PARAMS = {"zamba2-1.2b": 1_104_777_344, "xlstm-350m": 163_851_292}
# train steps on the fixed batch. An xlstm step takes 27–35 s on an H100
# 80GB HBM3 at 700 W (the sLSTM loops' host time), so 2, cut from
# LM_STEPS to keep the smoke in its limit. Its loss need not fall: at
# full width its gradient norm is 2e12–3e12 (the mLSTM normaliser
# max(|n|, 1e-6) meets a near-zero n: ``step_spans`` prints where), and
# the clip to 1.0 scales the gradient by ~4e-13, below AdamW's eps for
# all but the few entries that carry the spike; ``block_grads`` holds the
# card's xlstm gradients instead
SSM_STEPS = {"zamba2-1.2b": LM_STEPS - 1, "xlstm-350m": 2}
# zamba2's steps were LM_STEPS until phase 27 came (its losses still fall
# at each of two steps); phase 27 prints the seconds the cut saved (the
# steps not run, at the mean of steps 1..)
SSM_TRIMMED = {"zamba2-1.2b": LM_STEPS}
# the whole model's decode is held at LM_DECODE_TOL where, as in phases
# 20–21, the model is f32 and no mixer divides by a sum that can cancel
# (zamba2: Mamba2 and attention); zamba2 in bf16 (44 layers against the
# 3 the limit was set on) and xlstm (its mLSTM divides by the normaliser
# n) print their distance against it as a reading. ``block_decode``
# holds every block's decode in all four
SSM_DECODE_HELD = {("zamba2-1.2b", "float32")}
GRAD_SEQ = 512          # block_grads' sequence: two mLSTM chunks of 256
GRAD_F32_TOL = 1e-4     # a leaf's relative distance, card f32 to CPU f32
GRAD_BF16_RATIO = 2.0   # card bf16 against the CPU's own bf16 distance,
                        # the factor the CPU train tests allow
SSM_PHASE = (f"recurrent archs: {' and '.join(SSM_ARCHS)} at full width, "
             f"zamba2 at full depth, xlstm at 1 of 3 super-blocks; seq "
             f"{LM_SEQ}, batch {LM_BATCH}")


def ssm_config(arch: str):
    """Phase 22's config of ``arch``: the published one, xlstm's segment
    cut to ``SSM_SUPER`` super-blocks; and the published one."""
    import dataclasses

    from repro_torch import configs
    full = configs.get_config(arch)
    if arch not in SSM_SUPER:
        return full, full
    seg = full.segments[0]
    return dataclasses.replace(full, segments=(dataclasses.replace(
        seg, repeat=SSM_SUPER[arch]),)), full


def ssm_width(cfg) -> tuple:
    """The widths and depths of a phase-22 config, as ``SSM_WIDTH``."""
    blocks = [b for seg in cfg.segments for _ in range(seg.repeat)
              for b in seg.blocks]
    kinds = [b.kind for b in blocks]
    if cfg.shared_block is not None:                  # zamba2
        mb, sh = blocks[0].mamba, cfg.shared_block
        return (cfg.d_model, kinds.count("mamba2"), mb.d_state, mb.head_dim,
                mb.n_heads, sum(b.shared for b in blocks), sh.attn.n_heads,
                sh.attn.d_head, sh.ffn.d_ff, cfg.vocab)
    return (cfg.d_model, kinds.count("mlstm"), kinds.count("slstm"),
            blocks[0].mlstm.n_heads, cfg.vocab)


@contextlib.contextmanager
def spy(mod, name: str, sink: list, pick):
    """``mod.name`` wrapped so that each call appends ``pick(args,
    result)`` to ``sink``."""
    real = getattr(mod, name)

    def wrapped(*args):
        res = real(*args)
        sink.append(pick(args, res))
        return res

    setattr(mod, name, wrapped)
    try:
        yield
    finally:
        setattr(mod, name, real)


@contextlib.contextmanager
def step_spans(torch, out: dict):
    """Inside, a train step's blocks are bracketed by CUDA events on the
    card's timeline: each block's forward as the step first runs it, and
    its backward (the recompute of its checkpointed forward, then its
    gradients) from the hook on its output's gradient to the hook on its
    input's, so the spans are disjoint parts of the step. Each mLSTM
    block's normaliser |n| (the last channel of its SSD read, (B, S, H))
    is reduced on the card as the forward runs. On exit ``out`` holds
    ``spans`` ({kind: [forward ms, backward ms, blocks]}) and ``norms``
    (per mLSTM block in program order: min |n|, median |n|, entries below
    1e-6 (the clamp), entries below 1e-4 of the median, and the (b, s, h)
    of the min)."""
    from repro_torch.models import model as M, ssm as S

    real_block, real_out = M._block_forward, S._mlstm_out
    spans, norms, flag = [], [], {"backward": False}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def block(p, blk, cfg, x, positions, want_cache):
        if flag["backward"]:                  # a checkpoint's recompute
            return real_block(p, blk, cfg, x, positions, want_cache)
        ev = {"f0": event()}
        y, cache = real_block(p, blk, cfg, x, positions, want_cache)
        ev["f1"] = event()

        def opened(_):
            flag["backward"] = True
            ev["b0"] = event()

        def closed(_):
            ev["b1"] = event()

        if y.requires_grad and x.requires_grad:
            y.register_hook(opened)
            x.register_hook(closed)
        spans.append((blk.kind + " (shared)" * blk.shared, ev))
        return y, cache

    def read(params, spec, x, y, z, sh=None):
        if not flag["backward"]:
            with torch.no_grad():
                n = y[..., spec.d_v].to(torch.float32).abs()    # (B, S, H)
                med = n.median()
                norms.append((n.shape, torch.stack([
                    n.min().double(), med.double(), (n < 1e-6).sum().double(),
                    (n < 1e-4 * med).sum().double(), n.argmin().double()])))
        return real_out(params, spec, x, y, z, sh)

    M._block_forward, S._mlstm_out = block, read
    try:
        yield
    finally:
        M._block_forward, S._mlstm_out = real_block, real_out
    torch.cuda.synchronize()
    by_kind = {}
    for kind, ev in spans:
        row = by_kind.setdefault(kind, [0.0, 0.0, 0])
        row[0] += ev["f0"].elapsed_time(ev["f1"])
        row[1] += ev["b0"].elapsed_time(ev["b1"])
        row[2] += 1
    out["spans"] = by_kind
    out["norms"] = []
    for shape, t in norms:
        lo, med, clamped, below, at = t.tolist()
        out["norms"].append((lo, med, int(clamped), int(below),
                             tuple(int(i) for i in np.unravel_index(
                                 int(at), tuple(shape)))))


def ssm_train(torch, arch: str, cfg, batch, tc, steps: int) -> tuple:
    """``steps`` train steps of a fresh state (seed 0) on one fixed batch,
    step 1 inside :func:`step_spans`. Returns (state, readings): the
    losses and gradient norms (before the clip), the walls, tokens/s after
    step 0, the peak memory, and step 1's milliseconds on the card's
    timeline, its blocks' spans by kind and the mLSTM normalisers."""
    from repro_torch.train import steps as ST

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, _ = ST.init_state(0, cfg, tc, device=torch.device(DEVICE))
    torch.cuda.synchronize()
    print(f"  {state.params.n_params():,} parameters; init "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    step = ST.make_train_step(cfg, tc)
    losses, norms, walls, traced = [], [], [], {}
    for i in range(steps):
        t0 = time.perf_counter()
        with (step_spans(torch, traced) if i == 1
              else contextlib.nullcontext()):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, metrics = step(state, batch)
            e1.record()
            losses.append(float(metrics["loss"]))      # syncs
        walls.append(time.perf_counter() - t0)
        norms.append(float(metrics["grad_norm"]))
        if i == 1:
            traced["step_ms"] = e0.elapsed_time(e1)
        print(f"  step {i}: loss {losses[-1]:.6f} grad_norm "
              f"{norms[-1]:.6g} wall {walls[-1]:.3f} s", flush=True)
    tokens = LM_BATCH * LM_SEQ
    tok_s = tokens * (len(walls) - 1) / sum(walls[1:])
    peak = torch.cuda.max_memory_allocated()
    print(f"  {arch}: losses {losses}; {tok_s:,.0f} tokens/s over steps "
          f"1..{len(walls) - 1} ({tokens} tokens a step); "
          f"max_memory_allocated {peak / 2**30:.2f} GiB", flush=True)
    step_ms = traced["step_ms"]
    rest = step_ms - sum(f + b for f, b, _ in traced["spans"].values())
    print(f"  step 1 on the card's timeline (CUDA events) {step_ms:.1f} ms: "
          + "; ".join(f"{n} × {kind}: forward {f:.1f} ms, backward (with "
                      f"the recompute) {b:.1f} ms, {(f + b) / step_ms:.1%}"
                      for kind, (f, b, n) in traced["spans"].items())
          + f"; the rest (embedding, loss, optimizer) {rest:.1f} ms, "
            f"{rest / step_ms:.1%}", flush=True)
    if traced["norms"]:
        print(f"  step 1's mLSTM normaliser |n| over (batch, position, head)"
              f" per block in program order: min / median, entries below "
              f"1e-6 (the clamp) and below 1e-4 of the median, (b, s, h) of "
              f"the min:", flush=True)
        for i, (lo, med, clamped, below, at) in enumerate(traced["norms"]):
            print(f"    mLSTM {i:2d}: {lo:.3g} / {med:.3g}, {clamped}, "
                  f"{below}, {at}", flush=True)
    assert np.isfinite(losses).all(), losses
    return state, {"losses": losses, "grad_norms": norms, "step_s": walls,
                   "tokens_per_s": tok_s, "peak_gib": peak / 2**30,
                   "step1_ms": step_ms, "spans": traced["spans"],
                   "mlstm_norms": traced["norms"]}


def ssm_decode(torch, model, cfg, name: str, toks, prefill: int,
               held: bool, fails: list) -> dict:
    """The whole model's decode of ``toks`` (1, S) against its full
    forward's logits in the compute dtype ``name``: a prefill of
    ``prefill`` tokens, its caches padded (``pad_caches``: attention
    caches to S positions, recurrent states untouched), then decode steps
    to the end; ``prefill=0`` decodes token by token from an empty cache.
    Compared over the decoded positions (and the prefill's last), relative
    to max|logits|, against ``LM_DECODE_TOL[name]``: held where ``held``
    (``SSM_DECODE_HELD``), a reading elsewhere. Returns the readings."""
    from repro_torch.models import model as M, pad_caches
    from repro_torch.train import steps as ST

    s = toks.shape[1]
    first = max(prefill - 1, 0)
    cdt = torch.float32 if name == "float32" else torch.bfloat16
    tcd = ST.TrainConfig(compute_dtype=name)
    decode = ST.make_decode_step(cfg, tcd)
    t0 = time.perf_counter()
    with torch.no_grad():
        tree = model.tree(cast=cdt)
        x, pos, _ = M._embed_inputs(tree, cfg, {"tokens": toks}, cdt)
        h, _ = M.backbone(tree, cfg, x, pos)
        want = M.logits_for(tree, cfg, h[:, first:])
        del tree, x, h
    outs = []
    if prefill:
        last, caches = ST.make_prefill_step(cfg, tcd)(
            model, {"tokens": toks[:, :prefill]})
        padded = pad_caches(caches, s)
        for c, pc in zip(sum(caches, []), sum(padded, [])):
            for b in c:
                for k in c[b]:
                    seq = set(c[b]) in M._SEQ_CACHES
                    assert (pc[b][k].shape[-2] == s if seq
                            else pc[b][k] is c[b][k]), (b, k)
        caches = padded
        outs.append(last[:, 0])
    else:
        caches = M.cache_init(cfg, 1, s, dtype=cdt, device=toks.device)
    for t in range(prefill, s):
        lg, caches = decode(model, toks[:, t:t + 1], caches, t)
        outs.append(lg[:, 0])
    got = torch.stack(outs, 1)
    del caches
    scale = float(want.abs().max())
    err = float((got - want).abs().max()) / scale
    within = err <= LM_DECODE_TOL[name]
    torch.cuda.synchronize()
    how = (f"prefill {prefill} tokens then decode {s - prefill}" if prefill
           else f"token by token from an empty cache over {s} positions")
    print(f"  {name}, the whole model: {how}: max|Δlogits| "
          f"{err * scale:.4g} of max|logits| {scale:.4g} ({err:.3g}; within "
          f"LM_DECODE_TOL {LM_DECODE_TOL[name]:g}: {within}, "
          f"{'held' if held else 'a reading'}); top-1 agree "
          f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/{got.shape[1]}"
          f"; {time.perf_counter() - t0:.2f} s", flush=True)
    if not bool(torch.isfinite(got).all()):
        fails.append(f"{cfg.name} {name} decode: logits not finite")
    if held and not within:
        fails.append(f"{cfg.name} {name} decode: {err:.3g} > "
                     f"{LM_DECODE_TOL[name]:g}")
    return {f"decode_rel_err_{name}": err,
            f"decode_within_tol_{name}": within}


def block_decode(torch, model, cfg, name: str, toks, prefill: int,
                 fails: list) -> dict:
    """Every block's decode against its own forward, in the compute dtype
    ``name``, each block on the forward's input (the previous block's
    forward output, so no block inherits another's rounding): its forward
    over all S tokens of ``toks`` (1, S) with its caches, against its
    decode from a prefill of ``prefill`` tokens (caches padded by
    ``pad_caches``) or, ``prefill=0``, from ``cache_init``'s empty cache,
    token by token to S. Held at ``LM_DECODE_TOL[name]``, each relative to
    that block's forward max|.|: every final cache (attention k and v,
    Mamba2 ssm and conv, mLSTM h, sLSTM h, c, n and m) and the outputs
    from the prefill's last position on. An mLSTM block's forward scales
    its state and its SSD read by exp(−m̂), m̂ the max over the sequence of
    its log input gate (the reference's stabiliser), and decode does not,
    so both are held times exp(m̂); its output divides that read by its
    normaliser channel, which comes near zero, so it is a reading.
    Returns the largest error by (kind, what)."""
    from repro_torch.models import model as M, pad_caches, ssm as S

    cdt = torch.float32 if name == "float32" else torch.bfloat16
    s = toks.shape[1]
    first = max(prefill - 1, 0)
    errs, readings = {}, {}

    def rel(got, want):
        want = want.float()
        top = float(want.abs().max())
        return float((got.float() - want).abs().max()) / (top or 1.0)

    def hold(kind, what, got, want, into=errs):
        into[(kind, what)] = max(into.get((kind, what), 0.0),
                                 rel(got, want))

    t0 = time.perf_counter()
    with torch.no_grad():
        tree = model.tree(cast=cdt)
        x, pos, _ = M._embed_inputs(tree, cfg, {"tokens": toks}, cdt)
        empty = M.cache_init(cfg, 1, s, dtype=cdt, device=toks.device)
        for si, seg in enumerate(cfg.segments):
            for li, lp in enumerate(tree["segments"][si]):
                for bi, blk in enumerate(seg.blocks):
                    bp = tree["shared"] if blk.shared else lp[f"b{bi}"]
                    kind = blk.kind + " (shared)" * blk.shared
                    gates, reads = [], []
                    assert not (prefill and blk.kind == "mlstm")
                    with spy(S, "_mlstm_gates", gates, lambda a, r: r[0]), \
                            spy(S, "_mlstm_out", reads, lambda a, r: a[3]):
                        want, wc = M._block_forward(bp, blk, cfg, x, pos,
                                                    True)
                        outs = []
                        if prefill:
                            y, c = M._block_forward(
                                bp, blk, cfg, x[:, :prefill],
                                pos[:, :prefill], True)
                            c = pad_caches([[{"b": c}]], s)[0][0]["b"]
                            outs.append(y[:, -1:])
                        else:
                            c = empty[si][li][f"b{bi}"]
                        for t in range(prefill, s):
                            y, c = M._block_decode(bp, blk, cfg,
                                                   x[:, t:t + 1], c, t)
                            outs.append(y)
                    got = torch.cat(outs, 1)
                    if blk.kind == "mlstm":
                        up = torch.exp(torch.amax(gates[0], dim=1))  # (B,H)
                        hold(kind, "read", torch.cat(reads[1:], 1),
                             reads[0].float() * up[:, None, :, None])
                        hold(kind, "h", c["h"], wc["h"] * up[..., None, None])
                        hold(kind, "out", got, want[:, first:], readings)
                    else:
                        hold(kind, "out", got, want[:, first:])
                        for k in wc:
                            hold(kind, k, c[k], wc[k])
                    x = want
        del tree, x, empty
    torch.cuda.synchronize()
    tol = LM_DECODE_TOL[name]
    bad = {k: e for k, e in errs.items() if not e <= tol}
    print(f"  {name}, block by block on the forward's inputs (held at "
          f"{tol:g}): " + ", ".join(f"{k} {w} {e:.3g}"
                                    for (k, w), e in errs.items())
          + "".join(f"; {k} {w} {e:.3g} (a reading)"
                    for (k, w), e in readings.items())
          + f"; {time.perf_counter() - t0:.2f} s", flush=True)
    if bad:
        fails.append(f"{cfg.name} {name} block decode over {tol:g}: {bad}")
    return {f"block_decode_{name}": {f"{k} {w}": e
                                     for (k, w), e in errs.items()}}


def block_grads(torch, model, cfg, fails: list) -> dict:
    """The train step's gradients on the card, held block by block: layer
    0's first mLSTM and first sLSTM block of the trained xlstm, on a
    seeded (1, ``GRAD_SEQ``, d) input and cotangent, the gradients into
    its input and its f32 parameters (through the train step's cast in
    bf16), on the card in f32 and bf16 and on the CPU in f32 and bf16.
    Each leaf's distance is ‖g − g_ref‖ / ‖g_ref‖, g_ref the CPU's f32:
    the card's f32 at most ``GRAD_F32_TOL``; the card's bf16 at most
    ``GRAD_BF16_RATIO`` times the CPU's own bf16 distance. Printed beside
    them as readings: the f32 max-entry error against the leaf's largest
    entry and the bf16 cosine, which few entries rule (a (position, head)
    with |n| near zero; f_bias has 4). Returns the worst of each by block
    kind."""
    import copy

    from repro_torch.models import layers as L, model as M

    rng = np.random.default_rng(26)
    shape = (1, GRAD_SEQ, cfg.d_model)
    x_np = rng.standard_normal(shape).astype(np.float32)
    w_np = rng.standard_normal(shape).astype(np.float32)
    blocks = cfg.segments[0].blocks
    kinds = [b.kind for b in blocks]

    def grads(mod, blk, dev, cdt):
        m = copy.deepcopy(mod).to(dev)
        x = torch.from_numpy(x_np).to(dev).requires_grad_(True)
        p = L.param_tree(m, cast=None if cdt == torch.float32 else cdt)
        y, _ = M._block_forward(p, blk, cfg, x.to(cdt), None, False)
        loss = (y.float() * torch.from_numpy(w_np).to(dev)).sum()
        names = ["input"] + [n for n, _ in m.named_parameters()]
        gs = torch.autograd.grad(loss, [x] + list(m.parameters()))
        return {n: g.detach().double().cpu() for n, g in zip(names, gs)}

    def dist(a, b):
        return {n: float((a[n] - r).norm() / (r.norm() or 1.0))
                for n, r in b.items()}

    out = {}
    for kind in ("mlstm", "slstm"):
        bi = kinds.index(kind)
        t0 = time.perf_counter()
        mod = model.segments[0][0][f"b{bi}"]
        ref = grads(mod, blocks[bi], "cpu", torch.float32)
        ref16 = grads(mod, blocks[bi], "cpu", torch.bfloat16)
        g32 = grads(mod, blocks[bi], DEVICE, torch.float32)
        g16 = grads(mod, blocks[bi], DEVICE, torch.bfloat16)
        d32, d16, d16_cpu = dist(g32, ref), dist(g16, ref), dist(ref16, ref)
        ratio = {n: d16[n] / d16_cpu[n] if d16_cpu[n] else
                 (0.0 if d16[n] == 0 else float("inf")) for n in ref}
        top = {n: float((g32[n] - r).abs().max() / (r.abs().max() or 1.0))
               for n, r in ref.items()}
        cos = {n: float(torch.nn.functional.cosine_similarity(
            g16[n].flatten(), r.flatten(), dim=0)) for n, r in ref.items()}
        w32, w16 = max(d32, key=d32.get), max(ratio, key=ratio.get)
        wt, wc = max(top, key=top.get), min(cos, key=cos.get)
        print(f"  {kind} block b{bi} of layer 0, gradients at seq {GRAD_SEQ} "
              f"against the CPU's f32 ({len(ref)} leaves with the input): "
              f"card f32 worst {w32} {d32[w32]:.3g} (limit "
              f"{GRAD_F32_TOL:g}); card bf16 worst {w16} {d16[w16]:.3g}, "
              f"{ratio[w16]:.3g}× the CPU's bf16 {d16_cpu[w16]:.3g} (limit "
              f"{GRAD_BF16_RATIO:g}×); readings: f32 max entry {wt} "
              f"{top[wt]:.3g} of its largest, bf16 least cosine {wc} "
              f"{cos[wc]:.6f}; {time.perf_counter() - t0:.2f} s", flush=True)
        if not d32[w32] <= GRAD_F32_TOL:
            fails.append(f"{kind} f32 gradient {w32}: {d32[w32]:.3g}")
        if not ratio[w16] <= GRAD_BF16_RATIO:
            fails.append(f"{kind} bf16 gradient {w16}: {ratio[w16]:.3g}× "
                         f"the CPU's bf16 distance")
        out[kind] = {"f32_dist": d32[w32], "bf16_ratio": ratio[w16],
                     "f32_max_entry": top[wt], "bf16_least_cos": cos[wc]}
    return out


def ssm_checkpoint(torch, cfg, state, tmp: str) -> dict:
    """(c): the trained xlstm state (bf16 moments) saved in the
    reference's layout and restored on the CPU: every leaf equal, the
    moments bf16 again. Returns the readings."""
    import torch.utils._pytree as pytree

    from repro_torch.checkpoint import restore, save
    from repro_torch.convert import (train_state_from_reference,
                                     train_state_to_reference)

    step = int(state.step)
    t0 = time.perf_counter()
    saved = train_state_to_reference(state)
    ckpt = os.path.join(tmp, "ssm_ckpt")
    save(ckpt, step, saved)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree, _ = restore(ckpt, step, saved, device="cpu")
    restore_s = time.perf_counter() - t0
    equal = same_tree(saved, tree)
    back = train_state_from_reference(tree, cfg, device="cpu")
    m_dtypes = {str(t.dtype) for t in back.opt.m.values()}
    n_bf16 = sum(t is not None and t.dtype == torch.bfloat16
                 for t in pytree.tree_leaves(tree))
    print(f"(c) {cfg.name} state after {step} steps: save {save_s:.2f} s, "
          f"restore {restore_s:.2f} s; {n_bf16} bf16 leaves of "
          f"{len(pytree.tree_leaves(tree))}; restored leaves equal the saved "
          f"ones {equal}; the restored moments' dtypes {sorted(m_dtypes)}",
          flush=True)
    assert equal and n_bf16 > 0 and m_dtypes == {"torch.bfloat16"}
    assert int(back.step) == step
    return {"ckpt_save_s": save_s, "ckpt_restore_s": restore_s,
            "ckpt_bf16_leaves": n_bf16}


def start_clis(tmp: str) -> tuple:
    """Phase 22(d): ``python -m repro_torch.launch.train --arch A --tiny
    --steps 10`` for both recurrent archs, started at once. Returns what
    :func:`join_clis` takes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    runs = {}
    for arch in SSM_ARCHS:
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                arch, "--tiny", "--steps", "10"]
        if DEVICE != "cuda":
            argv += ["--device", DEVICE]
        runs[arch] = (argv, subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=tmp, env=env))
    return runs, time.perf_counter()


def join_clis(runs: dict, t0: float) -> None:
    """Wait for :func:`start_clis`'s runs: each exits 0 with finite
    losses."""
    for arch, (argv, proc) in runs.items():
        out, err = proc.communicate(timeout=600)
        print(f"(d) {' '.join(argv[1:])}: exit {proc.returncode}, "
              f"{time.perf_counter() - t0:.2f} s after the start of both")
        for line in out.splitlines():
            print(f"    {line}")
        assert proc.returncode == 0, err[-3000:]
        assert "10 steps in" in out
        cli = [float(x) for x in re.findall(r"loss\s+(\S+)", out)]
        assert cli and np.isfinite(cli).all(), cli


def ssm_phase(torch, tmp: str, clis: tuple) -> dict:
    """Phase 22, the recurrent architectures at full width (see the module
    doc; xlstm at ``SSM_SUPER`` super-blocks): (a) zamba2-1.2b trained,
    then prefill + decode
    against the forward, the whole model and block by block; (b)
    xlstm-350m trained, its mLSTM and sLSTM gradients held against the
    CPU's, decode token by token against the forward, the whole model and
    block by block; (c) a checkpoint round trip of an xlstm state with
    bf16 moments; (d) both ``--tiny`` CLI runs; (e) no kernel of the six
    and no plain version runs. Every check's failure is gathered and
    raised at the end. Returns the readings."""
    from repro_torch.data import SyntheticLM, to_device
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST

    before = (dict(ops.launch_counts()), dict(ops.plain_counts()))
    # (d) runs beside (a)–(c): both entry points, as a user runs them, on
    # the card, at once (started by the caller before the phase)
    dev = torch.device(DEVICE)
    readings, fails = {}, []
    for arch in SSM_ARCHS:
        cfg, full = ssm_config(arch)
        width = ssm_width(full)
        xl = arch == "xlstm-350m"
        mdt = "bfloat16" if xl else "float32"
        print(f"({'ab'[SSM_ARCHS.index(arch)]}) {arch} at full width "
              f"{width} (published depth {full.n_layers} layers; trained "
              f"at {cfg.n_layers}); seq {LM_SEQ}, batch {LM_BATCH}; bf16 "
              f"compute, AdamW lr {LM_LR:g}, {mdt} moments; "
              f"{SSM_STEPS[arch]} steps", flush=True)
        assert width == SSM_WIDTH[arch], width
        batch = to_device(SyntheticLM(vocab=cfg.vocab, seq=LM_SEQ,
                                      global_batch=LM_BATCH).host_batch(0),
                          dev)
        tc = ST.TrainConfig(opt=adamw.OptConfig(
            lr=LM_LR, warmup_steps=1, total_steps=100, moment_dtype=mdt))
        state, r = ssm_train(torch, arch, cfg, batch, tc, SSM_STEPS[arch])
        del batch
        if arch in SSM_TRIMMED:
            readings["trim_s"] = (SSM_TRIMMED[arch] - SSM_STEPS[arch]) * (
                sum(r["step_s"][1:]) / len(r["step_s"][1:]))
        r["params"] = state.params.n_params()
        assert r["params"] == SSM_PARAMS[arch], r["params"]
        losses = r["losses"]
        r["falls"] = all(b < a for a, b in zip(losses, losses[1:]))
        model = state.params
        if xl:
            # see SSM_STEPS: the clip scales the gradient below AdamW's
            # eps, so the gradients are held block by block instead
            print(f"  loss falls at every step: {r['falls']}; gradient norms "
                  f"{r['grad_norms']} against the clip "
                  f"{tc.opt.grad_clip:g}", flush=True)
            r["block_grads"] = block_grads(torch, model, cfg, fails)
        elif not r["falls"]:
            fails.append(f"{arch} losses do not fall: {losses}")
        toks = torch.from_numpy(np.random.default_rng(22).integers(
            0, cfg.vocab, (1, LM_PREFILL + LM_DECODE), dtype=np.int32)).to(dev)
        # decode against the forward: zamba2 after a prefill (its
        # attention caches padded, its Mamba2 states untouched); xlstm
        # token by token (the mLSTM stabiliser scales a prefill's state)
        if xl:
            toks, prefill = toks[:, :LM_DECODE], 0
        else:
            prefill = LM_PREFILL
        for name in ("float32", "bfloat16"):
            r.update(ssm_decode(torch, model, cfg, name, toks, prefill,
                                (arch, name) in SSM_DECODE_HELD, fails))
            r.update(block_decode(torch, model, cfg, name, toks, prefill,
                                  fails))
        del model
        torch.cuda.empty_cache()
        readings[arch] = r
        if xl:
            readings.update(ssm_checkpoint(torch, cfg, state, tmp))
        del state
        torch.cuda.empty_cache()
    join_clis(*clis)

    after = (dict(ops.launch_counts()), dict(ops.plain_counts()))
    print(f"(e) kernel launches and plain-version calls before the phase "
          f"{before}, after {after}: equal {after == before}")
    assert after == before
    assert not fails, fails
    return readings


# Phase 23, the sharded LM step (ROADMAP item 14d) on phase 20's config
SHARD_STEPS = 2         # (a): steps of each arm on phase 20's fixed batch
SHARD_CLI_ARCH = "deepseek-v2-lite-16b"
# (b): torchrun's run, then the resumed run's end (6 and 9 in three
# processes took the phase 88.45 s on the card; 2 and 4 with two runs in
# this process, 101.64 s: torchrun's process start, 57.68 s, now runs
# beside (a))
SHARD_CLI_STEPS = (2, 4)
SHARD_BYTES_ARCHS = ("yi-9b", "deepseek-v2-lite-16b", "nemotron-4-340b")
SHARD_BYTES_MESHES = ((1, 1), (16, 16), (2, 16, 16))
SHARD_PHASE = (f"sharded LM step: NCCL world of 1, (1, 1) (\"data\", "
               f"\"model\") mesh; {LM_ARCH} at full width, L = {LM_DEPTH}; "
               f"{SHARD_CLI_ARCH} --tiny under torchrun")


def shard_arm(torch, cfg, tc, batch, mesh=None, host: bool = False) -> dict:
    """``SHARD_STEPS`` train steps of phase 20's config from seed 0, on one
    device or (``mesh``) sharded: losses, gradient norms, walls, peak
    memory, the collectives of each step, and the final state's leaves
    (params, m, v), moved to the host with ``host``."""
    from repro_torch import pshard
    from repro_torch.data import device_batch
    from repro_torch.train import steps as ST
    dev = torch.device(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    if mesh is None:
        state, sh = ST.init_state(0, cfg, tc, device=dev)
        step = ST.make_train_step(cfg, tc)
        rows = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in batch.items()}
    else:
        state, sh = ST.init_state(0, cfg, tc, mesh)
        step = ST.make_train_step(cfg, tc, mesh, sh, ST.batch_shardings(
            mesh, cfg, "train", batch))
        rows = device_batch(mesh, batch)
    out = {"losses": [], "grad_norms": [], "walls": [], "collectives": []}
    for _ in range(SHARD_STEPS):
        pshard.reset_collectives()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, rows)
        out["losses"].append(float(metrics["loss"]))
        out["grad_norms"].append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        out["walls"].append(time.perf_counter() - t0)
        out["collectives"].append(pshard.collective_counts())
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    move = (lambda t: t.detach().cpu()) if host else (lambda t: t.detach())
    out["state"] = {
        "params": {k: move(p) for k, p in state.params.named_parameters()},
        "m": {k: move(t) for k, t in state.opt.m.items()},
        "v": {k: move(t) for k, t in state.opt.v.items()}}
    del state, step, rows
    torch.cuda.empty_cache()
    return out


def shard_bytes() -> list[str]:
    """(c): per-rank bytes of the f32 masters and AdamW's two f32 moments
    of full-depth models on the production meshes, from ``resolve_tree``
    on meta-device shapes (no allocation)."""
    import math

    from repro_torch import configs, pshard
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models import model as M
    lines = []
    for arch in SHARD_BYTES_ARCHS:
        model = M.LM(configs.get_config(arch), device="meta")
        shapes = dict(model.named_parameters())
        total = sum(p.numel() for p in shapes.values())
        cells = []
        for dims in SHARD_BYTES_MESHES:
            mesh = pshard.MeshShape(mesh_axes(dims), dims)
            lays = pshard.resolve_tree(mesh, model.specs(), shapes)
            local = sum(math.prod(lay.local_shape) for lay in lays.values())
            cells.append(f"{dims}: {local * 12 / 2**30:.2f} GiB "
                         f"({local / total:.4f} of the whole)")
        lines.append(f"  {arch}: {total:,} parameters, masters + m + v "
                     f"{total * 12 / 2**30:.2f} GiB; per rank " +
                     "; ".join(cells))
    return lines


def shard_cli_args(tmp: str) -> tuple:
    """(b)'s ``launch.train`` arguments but ``--steps`` and ``--ckpt-dir``,
    and its two checkpoint directories."""
    base = ["--arch", SHARD_CLI_ARCH, "--tiny", "--mesh", "1x1",
            "--ckpt-every", str(SHARD_CLI_STEPS[0])]
    if DEVICE != "cuda":
        base += ["--device", DEVICE]
    return base, {k: os.path.join(tmp, f"shard_{k}")
                  for k in ("run", "whole")}


def torchrun_start(tmp: str) -> tuple:
    """(b)'s ``torchrun --nproc-per-node 1 -m repro_torch.launch.train
    --mesh 1x1`` (an NCCL world of 1 by torchrun's rendezvous) to step
    ``SHARD_CLI_STEPS[0]``, started in the background (its process start
    dominates). Returns (argv, process, start time)."""
    base, dirs = shard_cli_args(tmp)
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "1", "-m", "repro_torch.launch.train", *base,
            "--steps", str(SHARD_CLI_STEPS[0]), "--ckpt-dir", dirs["run"]]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=tmp,
                            env=dict(os.environ, PYTHONPATH=os.path.join(
                                HERE, "src")))
    return argv, proc, t0


def shard_cli_start(tmp: str, run: tuple | None = None) -> dict:
    """(b), first: :func:`torchrun_start`'s run (``run``, started by the
    caller before the phase, else here) runs beside the rest of the phase
    while an uninterrupted run of ``launch.train.main`` in this process (a
    one-rank NCCL group of its own) goes to ``SHARD_CLI_STEPS[1]``."""
    from repro_torch.launch import train as launch_train
    argv, proc, t0 = run or torchrun_start(tmp)
    base, dirs = shard_cli_args(tmp)
    whole = base + ["--steps", str(SHARD_CLI_STEPS[1]), "--ckpt-dir",
                    dirs["whole"]]
    print(f"(b) torchrun started: {' '.join(argv[1:])}")
    print(f"(b) launch.train.main({' '.join(whole)}) in this process:")
    t_whole = time.perf_counter()
    launch_train.main(whole)
    return {"proc": proc, "argv": argv, "base": base, "dirs": dirs,
            "t0": t0, "walls": {"whole": time.perf_counter() - t_whole}}


def shard_cli_finish(cli: dict) -> dict:
    """(b), after (a): join torchrun, resume its checkpoint to
    ``SHARD_CLI_STEPS[1]`` in this process, and return the walls and both
    final checkpoints' leaves."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train as launch_train
    first, last = SHARD_CLI_STEPS
    out, err = cli["proc"].communicate(timeout=600)
    walls = cli["walls"]
    walls["torchrun"] = time.perf_counter() - cli["t0"]
    print(f"(b) {' '.join(cli['argv'][1:])}: exit {cli['proc'].returncode}, "
          f"{walls['torchrun']:.2f} s from its start (beside (a))")
    for line in out.splitlines():
        print(f"    {line}")
    assert cli["proc"].returncode == 0, err[-3000:]
    assert latest_step(cli["dirs"]["run"]) == first
    resume = cli["base"] + ["--steps", str(last), "--ckpt-dir",
                            cli["dirs"]["run"]]
    print(f"(b) launch.train.main({' '.join(resume)}) in this process:")
    t0 = time.perf_counter()
    _, losses = launch_train.main(resume)
    walls["resume"] = time.perf_counter() - t0
    assert list(losses) == list(range(first, last)), losses   # resumed

    def leaves(d):
        path = os.path.join(d, f"step_{last:08d}", "arrays.npz")
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    return {"walls": walls, "resumed": leaves(cli["dirs"]["run"]),
            "whole": leaves(cli["dirs"]["whole"])}


def shard_phase(torch, tmp: str, run: tuple | None = None) -> dict:
    """Phase 23, the sharded LM step on an NCCL world of 1 (see the module
    doc): (a) phase 20's train steps through ``make_train_step(...,
    mesh)`` against the unsharded step, bit for bit, with the
    collectives of each step; (b) ``launch.train`` under ``torchrun`` and
    a one-process resume of its checkpoint against an uninterrupted run;
    (c) the per-rank bytes of full-depth states on the production
    meshes. Returns the readings."""
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST

    cfg, _ = lm_config()
    tc = ST.TrainConfig(opt=adamw.OptConfig(lr=LM_LR, warmup_steps=1,
                                            total_steps=100))
    batch = SyntheticLM(vocab=cfg.vocab, seq=LM_SEQ,
                        global_batch=LM_BATCH).host_batch(0)
    before = (ops.launch_counts(), ops.plain_counts())
    started = shard_cli_start(tmp, run)
    one = shard_arm(torch, cfg, tc, batch, host=True)
    with nccl_world(torch, ("data", "model")) as mesh:
        sharded = shard_arm(torch, cfg, tc, batch, mesh)
    differ = []
    for part in ("params", "m", "v"):
        for k, t in one["state"][part].items():
            got = sharded["state"][part][k]
            if not (t.dtype == got.dtype
                    and torch.equal(t.to(got.device), got)):
                differ.append(f"{part}.{k}")
    n_leaves = sum(len(one["state"][p]) for p in ("params", "m", "v"))
    for name, arm in (("unsharded", one), ("sharded", sharded)):
        print(f"(a) {name}: losses {arm['losses']}, grad norms "
              f"{arm['grad_norms']}, walls "
              f"{[round(w, 4) for w in arm['walls']]} s, "
              f"max_memory_allocated {arm['peak_gib']:.2f} GiB", flush=True)
    for i, c in enumerate(sharded["collectives"]):
        print(f"    sharded step {i} collectives: " + ", ".join(
            f"{kind} ×{n} ({b / 2**20:.1f} MiB)" for kind, (n, b)
            in c.items()))
    print(f"    leaves (params, m, v) equal bit for bit: "
          f"{n_leaves - len(differ)} of {n_leaves}; losses and gradient "
          f"norms equal {sharded['losses'] == one['losses']} and "
          f"{sharded['grad_norms'] == one['grad_norms']}", flush=True)
    assert np.isfinite(one["losses"]).all()
    assert sharded["losses"] == one["losses"]
    assert sharded["grad_norms"] == one["grad_norms"]
    assert not differ, differ[:10]
    for c in sharded["collectives"]:         # issued at world size 1 too
        assert c.get("all_gather", (0, 0))[0] > 0
        assert c.get("all_reduce", (0, 0))[0] > 0
    del one["state"], sharded["state"]
    torch.cuda.empty_cache()
    cli = shard_cli_finish(started)
    equal = (sorted(cli["resumed"]) == sorted(cli["whole"]) and all(
        np.array_equal(cli["resumed"][k], cli["whole"][k])
        for k in cli["whole"]))
    print(f"(b) the resumed run's {len(cli['resumed'])} leaves at step "
          f"{SHARD_CLI_STEPS[1]} equal the uninterrupted run's leaf for "
          f"leaf: {equal}", flush=True)
    assert equal
    print("(c) per-rank bytes of f32 masters, m and v (resolve_tree on "
          "meta-device shapes):")
    lines = shard_bytes()
    print("\n".join(lines), flush=True)
    after = (ops.launch_counts(), ops.plain_counts())
    assert after == before, (before, after)
    return {"unsharded": {k: one[k] for k in ("losses", "grad_norms",
                                              "walls", "peak_gib")},
            "sharded": {k: sharded[k] for k in (
                "losses", "grad_norms", "walls", "peak_gib",
                "collectives")},
            "cli_walls": cli["walls"], "bytes": lines}


DRYRUN_PEAK_BAND = (0.9, 1.15)   # max_memory_allocated / the tracked peak
DRYRUN_CLI = (("--arch", "yi-9b", "--shape", "decode_32k", "--mesh",
               "single"),
              ("--arch", "lasso-screen-16m", "--mesh", "single"))
DRYRUN_PHASE = (f"dry run: {LM_ARCH} and {MOE_ARCH} steps against their fake "
                f"traces, the paper's pieces at {MNIST[0]} × {MNIST[1]}, the "
                f"CLI on (16, 16)")


def dryrun_cli_start(tmp: str) -> list:
    """(d), started first: ``python -m repro_torch.launch.dryrun`` for each
    of ``DRYRUN_CLI`` (fake worlds of 256 ranks, CPU work: they run beside
    the rest of the phase)."""
    procs = []
    for i, args in enumerate(DRYRUN_CLI):
        argv = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                "--out", os.path.join(tmp, f"dryrun_{i}"), "--device",
                DEVICE]
        procs.append((argv, subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=tmp, env=dict(os.environ, PYTHONPATH=os.path.join(
                HERE, "src")))))
    return procs


def dryrun_cli_finish(procs, fails: list) -> list:
    """(d): every CLI cell's one-line record, each ``ok``."""
    records = []
    for argv, proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        finally:
            stop_all([proc])
        lines = [ln for ln in out.splitlines() if ln.startswith("[record] ")]
        if proc.returncode != 0 or not lines:
            fails.append(f"(d) {argv[3:]}: exit {proc.returncode}, "
                         f"{out[-2000:]} {err[-2000:]}")
        for ln in lines:
            rec = json.loads(ln[len("[record] "):])
            rl = rec["roofline"]
            print(f"(d) {' '.join(argv[3:-4])}: status {rec['status']}, "
                  f"trace_s {rec['trace_s']}, flops/rank {rl['flops']:.4g}, "
                  f"bytes_fused {rl['hbm_bytes']:.4g}, collectives "
                  f"{rec['collectives']['counts']}, kernels "
                  f"{ {k: v['launches'] for k, v in rec['kernels'].items()} }"
                  f", peak/rank {rec['memory']['peak_per_device_gb']:.3f} GB "
                  f"(CPU trace)", flush=True)
            print("[record] " + json.dumps(rec), flush=True)
            if rec["status"] != "ok":
                fails.append(f"(d) {argv[3:]}: {rec}")
            records.append(rec)
    return records


def dryrun_arm(torch, smi: str, name: str, cfg, tc, batch,
               fails: list) -> dict:
    """(a)/(b): one real step of ``cfg`` under the cost model against the
    dry run of the same step on fake CUDA tensors: the flops must be
    equal, and a plain step's peak within ``DRYRUN_PEAK_BAND`` of the
    tracked peak; its wall beside the dry run's roofline (a reading)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.data import to_device
    from repro_torch.launch import dryrun, hlo, hlo_cost
    from repro_torch.train import steps as ST

    shape = ShapeSpec(name, "train", LM_SEQ, LM_BATCH)
    t0 = time.perf_counter()
    dry = dryrun.trace_step(cfg, shape, None, tc, device=DEVICE)
    trace_s = time.perf_counter() - t0
    assert dry["device"] == DEVICE, dry["device"]
    cost, predicted = dry["mode"].cost, dry["memory"]["peak_per_device_gb"]
    dev = torch.device(DEVICE)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    state, _ = ST.init_state(0, cfg, tc, device=dev)
    batch = to_device(batch, dev)
    step = ST.make_train_step(cfg, tc)
    with hlo_cost.CostMode() as real:
        state, metrics = step(state, batch)
        float(metrics["loss"])                           # syncs
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    rl = hlo.roofline_from_cost(cost, 1)
    share = cost.flops / (wall * hlo.H100_BF16_FLOPS_PER_S)
    lo, hi = DRYRUN_PEAK_BAND
    print(f"({name}) {cfg.name} L = {cfg.n_layers}, seq {LM_SEQ}, batch "
          f"{LM_BATCH}, bf16 [{smi}]: dry run (fake CUDA tensors, traced "
          f"in {trace_s:.2f} s CPU): flops {cost.flops:.6g} (products "
          f"{dry['mode'].dot_flops:.6g}), bytes_fused {cost.bytes_fused:.6g}"
          f", bytes {cost.bytes:.6g}; the real step under the same "
          f"CostMode: flops {real.cost.flops:.6g} (products "
          f"{real.dot_flops:.6g}): equal "
          f"{real.cost.flops == cost.flops}", flush=True)
    print(f"    tracked peak {predicted:.4f} GB against max_memory_allocated "
          f"{peak:.4f} GB above the phase's base (ratio "
          f"{peak / predicted:.4f}; band {lo}–{hi}: "
          f"{'met' if lo <= peak / predicted <= hi else 'missed'}); "
          f"roofline t_compute {rl.t_compute:.4f} s, t_memory "
          f"{rl.t_memory:.4f} s against the step's wall {wall:.4f} s (loss "
          f"{loss:.4f}); flops / (wall × 989e12) = {share:.4f}", flush=True)
    if real.cost.flops != cost.flops:
        fails.append(f"({name}) flops: real {real.cost.flops}, dry run "
                     f"{cost.flops}")
    if real.dot_flops != dry["mode"].dot_flops:
        fails.append(f"({name}) products: real {real.dot_flops}, dry run "
                     f"{dry['mode'].dot_flops}")
    if not lo <= peak / predicted <= hi:
        fails.append(f"({name}) peak {peak:.4f} GB against the tracked "
                     f"{predicted:.4f}: ratio {peak / predicted:.4f} outside "
                     f"{lo}–{hi}")
    del state, batch, metrics
    torch.cuda.empty_cache()
    return {"flops": cost.flops, "dot_flops": dry["mode"].dot_flops,
            "bytes_fused": cost.bytes_fused, "bytes": cost.bytes,
            "predicted_peak_gb": predicted, "peak_gb": peak, "wall_s": wall,
            "t_compute_s": rl.t_compute, "t_memory_s": rl.t_memory,
            "bf16_share": share, "trace_s": trace_s}


def dryrun_lasso(torch, fails: list) -> dict:
    """(c): ``dist_edpp_screen_cached`` and ``dist_fista`` (10 iterations,
    ``"chunked"``, ``capture=False``) at (1, 1) on the 784 × 50 000 data,
    real on an NCCL world of 1 against the dry run on a fake world of 1:
    each kernel's launches equal the charged launches, and a
    ``screen_matvec`` charge's bytes are the bound column's bytes."""
    from repro_torch.core import distributed as D
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.pshard import MeshShape

    n, p = MNIST
    X, y = make_dataset(n, p)
    real = {}
    with nccl_world(torch) as mesh:
        Xl = torch.from_numpy(X).to(DEVICE)
        yt = torch.from_numpy(y).to(DEVICE)
        beta0 = torch.zeros(p, device=DEVICE)
        lam_max = float(torch.max(torch.abs(yt @ Xl)))
        L = float(torch.linalg.eigvalsh(Xl @ Xl.T)[-1])     # ‖X‖₂²
        v1 = yt / float(torch.linalg.vector_norm(yt))
        norms = torch.linalg.vector_norm(Xl, dim=0)
        for key, fn in (
                ("screen", lambda: D.dist_edpp_screen_cached(
                    mesh, Xl, yt, 0.8 * lam_max, 0.9 * lam_max, beta0,
                    lam_max, v1, norms)),
                ("fista", lambda: D.dist_fista(
                    mesh, Xl, yt, 0.3 * lam_max, beta0, L, iters=10,
                    overlap="chunked", capture=False))):
            torch.cuda.synchronize()
            ops.reset_counts()
            out = fn()
            torch.cuda.synchronize()
            assert all(bool(torch.isfinite(t).all()) for t in
                       (out if isinstance(out, tuple) else (out,)))
            real[key] = {k: v for k, v in ops.launch_counts().items() if v}
    with dryrun.fake_world(1):
        mesh = make_mesh(MeshShape(("query", "feature"), (1, 1)), DEVICE)
        dry = {key: dryrun.trace_lasso(arch, mesh, DEVICE, n=n, p=p, **kw)
               for key, arch, kw in (
                   ("screen", "lasso-screen-16m",
                    {"variant": "cached_norms"}),
                   ("fista", "lasso-fista-16m", {}))}
    per_byte = bound("screen_matvec", n, p, 1)[0] / 1e3 * HBM_BYTES_PER_S
    out = {}
    for key in ("screen", "fista"):
        charged = dry[key]["mode"].kernels
        launches = {k: int(v["launches"]) for k, v in charged.items()}
        print(f"(c) {key}: launches {real[key]} real, {launches} charged; "
              + "; ".join(f"{k}: {v['flops']:.6g} flops, {v['bytes']:.6g} "
                          f"bytes charged" for k, v in charged.items()),
              flush=True)
        if launches != real[key]:
            fails.append(f"(c) {key}: launches {real[key]} real, {launches} "
                         f"charged")
        out[key] = {"launches": real[key], "charged": charged}
    sm = dry["screen"]["mode"].kernels["screen_matvec"]
    print(f"    screen_matvec charge {sm['bytes'] / sm['launches']:.6g} "
          f"bytes a launch; the bound column's bytes {per_byte:.6g} "
          f"(bound {bound('screen_matvec', n, p, 1)[0]:.4f} ms × "
          f"{HBM_BYTES_PER_S:.4g} B/s)", flush=True)
    if abs(sm["bytes"] / sm["launches"] - per_byte) > 1e-6 * per_byte:
        fails.append(f"(c) screen_matvec charge {sm['bytes']} bytes in "
                     f"{sm['launches']} launches against {per_byte:.6g}")
    return out


def dryrun_phase(torch, smi: str, tmp: str, procs=None) -> dict:
    """Phase 24, the dry run against the card (see the module doc): (a)
    phase 20's yi-9b step and (b) phase 21's deepseek step, each real
    under the cost model against its fake trace; (c) the paper's pieces
    at (1, 1); (d) the CLI on the production mesh, run beside them
    (``procs``: :func:`dryrun_cli_start`'s runs, started by the caller
    before the phase, else here). Every check's failure is gathered and
    raised at the end."""
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST

    procs = procs or dryrun_cli_start(tmp)
    tc = ST.TrainConfig(opt=adamw.OptConfig(lr=LM_LR, warmup_steps=1,
                                            total_steps=100))
    out, fails = {}, []
    try:
        for name, cfg in (("a", lm_config()[0]), ("b", moe_config()[0])):
            batch = SyntheticLM(vocab=cfg.vocab, seq=LM_SEQ,
                                global_batch=LM_BATCH).host_batch(0)
            out[name] = dryrun_arm(torch, smi, name, cfg, tc, batch, fails)
        out["c"] = dryrun_lasso(torch, fails)
    except BaseException:
        stop_all(proc for _, proc in procs)
        raise
    out["d"] = dryrun_cli_finish(procs, fails)
    assert not fails, fails
    return out


TP_MESH = (16, 16)      # the production mesh, ("data", "model")
TP_ROWS = 16            # train_4k's global batch of 256 over 16 data ranks
TP_LIMIT_GB = 80.0      # the card's memory
TP_CLI = ("--arch", LM_ARCH, "--shape", "train_4k", "--mesh", "single")
TP_PHASE = (f"tensor parallel: rank 0 of a fake world of 256, {TP_MESH}; "
            f"{LM_ARCH} at full width and depth, {TP_ROWS} × {LM_SEQ} of "
            f"train_4k, bf16, real tensors")


def tp_record(proc: tuple) -> dict:
    """The dry-run CLI's record of the cell (``ok``)."""
    argv, p = proc
    try:
        out, err = p.communicate(timeout=900)
    finally:
        stop_all([p])
    lines = [ln for ln in out.splitlines() if ln.startswith("[record] ")]
    assert p.returncode == 0 and lines, (argv, out[-2000:], err[-2000:])
    rec = json.loads(lines[-1][len("[record] "):])
    assert rec["status"] == "ok", rec
    return rec


@contextlib.contextmanager
def fake_rank(torch, cfg, seed: int):
    """Rank 0 of a fake world of ``TP_MESH`` ranks, for phases 25 and 26:
    yields a namespace of the mesh, the masters' ``layouts``, the rank's
    f32 ``shards`` of them drawn from ``gen`` (seeded with ``seed``, on
    the card; nothing whole is ever built), the ``model`` holding them,
    ``gen`` and ``base``, the memory allocated before. Its fields are
    dropped and the cache emptied on the way out."""
    from types import SimpleNamespace
    from repro_torch import pshard
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh, mesh_axes
    from repro_torch.models import model as M
    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    r = SimpleNamespace(base=torch.cuda.memory_allocated())
    try:
        with dryrun.fake_world(TP_MESH[0] * TP_MESH[1]):
            r.mesh = make_mesh(pshard.MeshShape(mesh_axes(TP_MESH), TP_MESH),
                               DEVICE)
            meta = M.LM(cfg, device="meta")
            r.layouts = pshard.resolve_tree(r.mesh, meta.specs(),
                                            dict(meta.named_parameters()))
            r.gen = torch.Generator(device=dev)
            r.gen.manual_seed(seed)
            r.shards = {k: torch.randn(lay.local_shape, generator=r.gen,
                                       device=dev) * 0.02
                        for k, lay in r.layouts.items()}
            r.model = M.holding(cfg, r.shards)
            yield r
    finally:
        vars(r).clear()
        torch.cuda.empty_cache()


def tp_step(torch, cfg, tc) -> dict:
    """One real train step of ``cfg`` as rank 0 of a fake world of
    ``TP_MESH`` ranks: the rank's shards of the masters drawn from a
    seeded generator on the card (nothing whole is ever built), its
    ``TP_ROWS`` rows of tokens, the step's wall and
    ``max_memory_allocated`` above the memory before the state. The fake
    group's collectives move nothing (its gathers and reductions leave
    their outputs unwritten), so the loss is not read."""
    from repro_torch import pshard
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST
    dev = torch.device(DEVICE)
    with fake_rank(torch, cfg, 0) as r:
        mesh, layouts = r.mesh, r.layouts
        state = ST.TrainState(r.model, adamw.init(tc.opt, r.shards),
                              torch.zeros((), dtype=torch.int32, device=dev))
        rep = pshard.Layout(pshard.P(), (), mesh)
        sh = ST.TrainState(layouts, adamw.AdamState(rep, layouts, layouts,
                                                    None), rep)
        whole = {k: torch.empty((TP_ROWS * TP_MESH[0], LM_SEQ),
                                device="meta") for k in ("tokens", "labels")}
        step = ST.make_train_step(cfg, tc, mesh, sh, ST.batch_shardings(
            mesh, cfg, "train", whole))
        batch = {k: torch.randint(0, cfg.vocab, (TP_ROWS, LM_SEQ),
                                  generator=r.gen, device=dev,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pshard.reset_collectives()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - r.base) / 1e9
        tags = pshard.collective_tags()
        del state, step, batch, sh
    return {"wall_s": wall, "peak_gb": peak, "tags": tags}


def tp_phase(torch, smi: str, proc: tuple, shard: dict | None) -> dict:
    """Phase 25 (see the module doc): (a) the real rank-0 step of yi-9b
    train_4k on (16, 16) against its dry run (``proc``: :func:`tp_cli_
    start`'s run) and the hand count; (b) phase 23's NCCL world of 1 on
    the same code, bit for bit the unsharded step (``shard``: its
    readings, None when phase 23 did not run)."""
    from repro_torch import configs
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST
    cfg = configs.get_config(LM_ARCH)
    tc = ST.TrainConfig(opt=adamw.OptConfig(lr=LM_LR, warmup_steps=1,
                                            total_steps=100))
    hand = hand_count(cfg)
    real = tp_step(torch, cfg, tc)
    rec = tp_record(proc)
    tracked = rec["memory"]["peak_per_device_gb"]
    flops = rec["roofline"]["flops"]
    dots = rec.get("dot_flops")
    lo, hi = DRYRUN_PEAK_BAND
    ratio = real["peak_gb"] / tracked
    print(f"(a) {cfg.name} L = {cfg.n_layers}, {TP_ROWS} × {LM_SEQ} on rank "
          f"0 of {TP_MESH}, bf16 [{smi}]: max_memory_allocated "
          f"{real['peak_gb']:.4f} GB against the dry run's tracked peak "
          f"{tracked:.4f} GB (ratio {ratio:.4f}, band {lo}–{hi}; limit "
          f"{TP_LIMIT_GB} GB); wall {real['wall_s']:.4f} s", flush=True)
    print(f"    dry run (CPU of this machine, {rec['trace_s']} s): flops "
          f"{flops:.6g}, products {dots}, useful-flops ratio "
          f"{rec.get('useful_flops_ratio')}; hand count: products "
          f"{hand['products']:.6g} (dense {hand['dense']:.6g}, attention "
          f"{hand['attention']:.6g}, head {hand['head']:.6g}), saved "
          f"inputs {hand['saved_inputs_gb']:.4f} GB, compute leaves "
          f"{hand['leaves']} ({hand['leaves_gb']:.4f} GB bf16 + f32), "
          f"masters and moments {hand['masters_moments_gb']:.4f} GB",
          flush=True)
    print("    collectives by purpose (calls, bytes; the fake group moves "
          "nothing): " + ", ".join(f"{k} {v[0]} ({v[1] / 2**20:.1f} MiB)"
                                   for k, v in real["tags"].items()),
          flush=True)
    if shard is not None:
        print(f"(b) phase 23's NCCL world of 1 on this code: losses "
              f"{shard['sharded']['losses']} equal the unsharded step's "
              f"{shard['unsharded']['losses']} bit for bit (asserted there)"
              f" [{smi}]", flush=True)
    assert real["peak_gb"] < TP_LIMIT_GB, real
    assert lo <= ratio <= hi, (real["peak_gb"], tracked)
    for tag in ("region", "vocab_max", "vocab_sum", "grad"):
        assert real["tags"].get(tag, (0, 0))[0] > 0, (tag, real["tags"])
    return {"real": real, "tracked_gb": tracked, "flops": flops,
            "dot_flops": dots, "hand": hand}


EP_SHAPES = ("train_4k", "decode_32k")     # phase 26's cells, (a) and (b)
EP_PHASE = (f"expert and MLA head parallel: rank 0 of a fake world of 256, "
            f"{TP_MESH}; {MOE_ARCH} at full width and depth, {TP_ROWS} × "
            f"{LM_SEQ} of train_4k and a decode_32k step, bf16, real "
            f"tensors")


def hand_count(cfg, rows: int = TP_ROWS, seq: int = LM_SEQ,
               dims: tuple = TP_MESH) -> dict:
    """The hand count of one train step of ``cfg`` (attention or MLA
    blocks, each with a dense FFN or a MoE, shared or not; Mamba2
    blocks; tied or untied head) on rank 0 of a ("data", "model") mesh
    of ``dims``, ``rows`` sequences of ``seq``: its products (flops) by
    part and its peak's parts (bytes). A dimension the model axis does
    not divide stays whole, as the rules leave it; a rank projects the
    kv heads its query heads read; every rank computes the MLA latents
    and the routing whole, and fills its experts' ``cap`` slots in each
    routing group of the whole batch; a Mamba2 rank projects its z, x
    and dt columns and every B and C column, and scans its heads in
    chunks (four products a chunk). A shared block's leaves count once,
    its products at every application."""
    data, model = dims
    t = rows * seq
    d = cfg.d_model

    def part(n):
        return n // model if n % model == 0 else n

    qc, kc = min(cfg.q_chunk, seq), min(cfg.k_chunk, seq)
    area = sum(qc * kc for qi in range(-(-seq // qc))
               for ki in range(-(-seq // kc)) if ki * kc <= qi * qc + qc - 1)
    linear = attn = last = 0            # forward products; the step's tiles
    whole = d                           # leaf elements replicated (norms),
    cut = 0                             # and with a d dim cut over "data"
    blocks = [(seg.repeat, blk) for seg in cfg.segments for blk in seg.blocks]
    if cfg.shared_block is not None:    # its leaves, once
        blocks.append((0, cfg.shared_block))
    for n, blk in blocks:
        # the leaves of a block applied n times: a shared one's count once
        own = 1 if blk is cfg.shared_block else 0 if blk.shared else n
        whole += own * (d if blk.kind == "mamba2" else 2 * d)
        if blk.kind == "mamba2":
            mb = blk.mamba
            hl, gn = part(mb.n_heads), mb.n_groups * mb.d_state
            dl = hl * mb.head_dim
            w_in = 2 * dl + 2 * gn + hl
            q = min(mb.chunk, seq)
            linear += n * t * (2 * d * w_in + 2 * dl * d + 2 * hl * (
                q * mb.d_state + q * mb.head_dim
                + 2 * mb.d_state * mb.head_dim))
            last += n * t * 2 * dl * d
            cut += own * (d * w_in + dl * d)
            whole += own * (mb.conv_k * (dl + 2 * gn) + dl + 3 * mb.n_heads)
            continue
        if blk.kind == "mla":
            m = blk.mla
            h, r, dq = part(m.n_heads), m.kv_lora_rank, m.d_nope + m.d_rope
            linear += n * t * (2 * d * (r + m.d_rope) + 2 * d * h * dq
                               + 2 * r * h * (m.d_nope + m.d_v)
                               + 2 * h * m.d_v * d)
            # 10 tile products: 5 at q·k's width, 5 at v's
            attn += n * 2 * area * h * rows * 5 * (dq + m.d_v)
            cut += own * d * (r + m.d_rope + h * dq + h * m.d_v)
            whole += own * (r + r * h * (m.d_nope + m.d_v))
        else:
            a = blk.attn
            hq, dh = part(a.n_heads), a.d_head
            g = a.n_heads // a.n_kv_heads
            hk = (a.n_kv_heads // model if a.n_kv_heads % model == 0
                  else (hq - 1) // g + 1)
            linear += n * t * (2 * d * dh * (hq + 2 * hk) + 2 * hq * dh * d)
            attn += n * 2 * area * hq * rows * 10 * dh
            cut += own * (2 * hq * dh + 2 * part(a.n_kv_heads) * dh) * d
        if blk.moe is not None:
            e = blk.moe
            el, f, fs = part(e.n_routed), e.d_expert, part(
                e.d_expert * e.n_shared)
            g = min(e.group_size, t * data)
            cap = max(1, int(g * e.top_k / e.n_routed * e.capacity_factor))
            ng = -(-t // g)
            linear += n * (ng * el * cap * 3 * 2 * d * f         # experts
                           + t * 2 * d * e.n_routed               # router
                           + 2 * 2 * ng * g * d * el * cap        # dispatch,
                           + t * 3 * 2 * d * fs)                  # combine,
            last += n * t * 2 * fs * d                            # shared
            cut += own * (3 * el * d * f + d * e.n_routed + 3 * d * fs)
        else:
            fl = part(blk.ffn.d_ff)
            gates = 3 if blk.ffn.kind in ("swiglu", "geglu") else 2
            linear += n * t * gates * 2 * d * fl
            last += n * t * 2 * fl * d
            cut += own * gates * d * fl
    vl = part(cfg.vocab)
    head = 4 * 2 * t * d * vl           # the chunked loss's four passes
    cut += vl * d * (1 if cfg.tie_embeddings else 2)
    # forward, backward (2×), the block's recompute less its last product
    dense = 4 * linear - last
    return {"products": dense + attn + head, "dense": dense,
            "attention": attn, "head": head,
            "saved_inputs_gb": cfg.n_layers * t * d * 2 / 1e9,
            "leaves": whole + cut, "leaves_gb": (whole + cut) * 6 / 1e9,
            "masters_moments_gb": (whole + cut // data) * 12 / 1e9}


def dryrun_cell_start(tmp: str, args: tuple, name: str) -> tuple:
    """``python -m repro_torch.launch.dryrun`` of one cell (``args``) on
    the production mesh, started first (CPU work: it runs beside the
    earlier LM phases). Returns (argv, process)."""
    argv = [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
            "--out", os.path.join(tmp, name), "--device", DEVICE]
    return argv, subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=tmp, env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))


def ep_cli_start(tmp: str) -> list:
    """(a)'s and (b)'s dry runs, one process each."""
    return [dryrun_cell_start(tmp, ("--arch", MOE_ARCH, "--shape", shape,
                                    "--mesh", "single"), f"dryrun_ep_{shape}")
            for shape in EP_SHAPES]


def ep_decode(torch, cfg, tc, names: tuple = ("c",)) -> dict:
    """(b): one decode_32k step of ``cfg`` as rank 0 of a fake world of
    ``TP_MESH`` ranks (:func:`fake_rank`): the rank's f32 master shards,
    its rows of the zero caches in :func:`steps.cache_layouts`' layouts
    (the MLA latent caches cut over positions; the recurrent states over
    heads, channels or widths), one new token into the last slot; the
    step's wall and ``max_memory_allocated`` above the memory before the
    inputs (as the dry run's peak counts them), and the specs and local
    shapes of block 0's caches ``names``."""
    from repro_torch import configs, pshard
    from repro_torch.models import model as M
    from repro_torch.train import steps as ST
    shape = configs.SHAPES["decode_32k"]
    dev = torch.device(DEVICE)
    with fake_rank(torch, cfg, 1) as r:
        mesh = r.mesh
        clay = ST.cache_layouts(cfg, mesh, shape.batch, shape.seq)
        whole = M.cache_init(cfg, shape.batch, shape.seq, device="meta")

        def zeros(tree, lay):
            if isinstance(tree, dict):
                return {k: zeros(v, lay[k]) for k, v in tree.items()}
            if isinstance(tree, list):
                return [zeros(v, lo) for v, lo in zip(tree, lay)]
            return torch.zeros(lay.local_shape, dtype=tree.dtype, device=dev)

        caches = zeros(whole, clay)
        lays = {n: clay[0][0]["b0"][n] for n in names}
        tok_lay = pshard.Layout(pshard.batch_spec(mesh, 2, shape.batch),
                                (shape.batch, 1), mesh)
        tok = torch.randint(0, cfg.vocab, tok_lay.local_shape,
                            generator=r.gen, device=dev, dtype=torch.int32)
        step = ST.make_decode_step(cfg, tc, mesh, r.layouts, clay,
                                   {"tokens": tok_lay})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pshard.reset_collectives()
        t0 = time.perf_counter()
        logits, caches = step(r.model, tok, caches, shape.seq - 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - r.base) / 1e9
        tags = pshard.collective_tags()
        out_shape = tuple(logits.shape)
        del logits, caches, step, tok
    return {"wall_s": wall, "peak_gb": peak, "tags": tags,
            "cache_spec": {n: tuple(lay.spec) for n, lay in lays.items()},
            "cache_local": {n: lay.local_shape for n, lay in lays.items()},
            "logits": out_shape}


def ep_phase(torch, smi: str, procs: list) -> dict:
    """Phase 26 (see the module doc): (a) the real rank-0 step of
    deepseek-v2-lite-16b train_4k on (16, 16) and (b) its decode_32k
    step, each against its dry run (``procs``: :func:`ep_cli_start`'s
    runs) and the hand count."""
    from repro_torch import configs, pshard
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST
    cfg = configs.get_config(MOE_ARCH)
    tc = ST.TrainConfig(opt=adamw.OptConfig(lr=LM_LR, warmup_steps=1,
                                            total_steps=100))
    hand = hand_count(cfg)
    real = {"train_4k": tp_step(torch, cfg, tc),
            "decode_32k": ep_decode(torch, cfg, tc)}
    recs = {shape: tp_record(p) for shape, p in zip(EP_SHAPES, procs)}
    lo, hi = DRYRUN_PEAK_BAND
    out = {"hand": hand}
    for (name, shape) in zip("ab", EP_SHAPES):
        r, rec = real[shape], recs[shape]
        tracked = rec["memory"]["peak_per_device_gb"]
        ratio = r["peak_gb"] / tracked
        print(f"({name}) {cfg.name} L = {cfg.n_layers}, {shape} on rank 0 "
              f"of {TP_MESH}, bf16 [{smi}]: max_memory_allocated "
              f"{r['peak_gb']:.4f} GB against the dry run's tracked peak "
              f"{tracked:.4f} GB (ratio {ratio:.4f}, band {lo}–{hi}; limit "
              f"{TP_LIMIT_GB} GB); wall {r['wall_s']:.4f} s; dry run (CPU "
              f"of this machine, {rec['trace_s']} s): flops "
              f"{rec['roofline']['flops']:.6g}, products "
              f"{rec.get('dot_flops')}, useful-flops ratio "
              f"{rec.get('useful_flops_ratio')}", flush=True)
        print("    collectives by purpose (calls, bytes; the fake group "
              "moves nothing): " + ", ".join(
                  f"{k} {v[0]} ({v[1] / 2**20:.1f} MiB)"
                  for k, v in r["tags"].items()), flush=True)
        assert r["peak_gb"] < TP_LIMIT_GB, (shape, r)
        assert lo <= ratio <= hi, (shape, r["peak_gb"], tracked)
        out[shape] = {"real": r, "tracked_gb": tracked,
                      "flops": rec["roofline"]["flops"],
                      "useful_flops_ratio": rec.get("useful_flops_ratio")}
    print(f"    hand count of (a): products {hand['products']:.6g} (dense "
          f"{hand['dense']:.6g}, attention {hand['attention']:.6g}, head "
          f"{hand['head']:.6g}), saved inputs {hand['saved_inputs_gb']:.4f}"
          f" GB, compute leaves {hand['leaves']} ({hand['leaves_gb']:.4f} "
          f"GB bf16 + f32), masters and moments "
          f"{hand['masters_moments_gb']:.4f} GB; (b)'s latent cache "
          f"{real['decode_32k']['cache_spec']}, local "
          f"{real['decode_32k']['cache_local']}, logits "
          f"{real['decode_32k']['logits']}", flush=True)
    tags = real["train_4k"]["tags"]
    for tag in ("mla", "experts", "shared", "region", "grad"):
        assert tags.get(tag, (0, 0))[0] > 0, (tag, tags)
    dec = real["decode_32k"]
    assert dec["cache_spec"]["c"][1] == pshard.MODEL_AXIS, dec
    for tag in ("decode_q", "decode_max", "decode_sum", "mla", "experts"):
        assert dec["tags"].get(tag, (0, 0))[0] > 0, (tag, dec["tags"])
    return out


SSM_TP_ARCH = "zamba2-1.2b"
SSM_TP_PHASE = (f"Mamba2 head parallel: rank 0 of a fake world of 256, "
                f"{TP_MESH}; {SSM_TP_ARCH} at full width and depth, "
                f"{TP_ROWS} × {LM_SEQ} of train_4k and a decode_32k step, "
                f"bf16, real tensors")


def ssm_tp_cli_start(tmp: str) -> list:
    """Phase 27's dry runs, (a) train_4k and (b) decode_32k of
    ``SSM_TP_ARCH``, one process each."""
    return [dryrun_cell_start(tmp, ("--arch", SSM_TP_ARCH, "--shape", shape,
                                    "--mesh", "single"), f"dryrun_ssm_{shape}")
            for shape in EP_SHAPES]


def ssm_tp_phase(torch, smi: str, procs: list,
                 trim_s: float | None = None) -> dict:
    """Phase 27 (see the module doc): (a) the real rank-0 step of
    zamba2-1.2b train_4k on (16, 16) and (b) its decode_32k step, each
    against its dry run (``procs``: :func:`ssm_tp_cli_start`'s runs) and
    the hand count. ``trim_s``: the seconds phase 22's cut saved, printed
    beside the phase's own."""
    from repro_torch import configs, pshard
    from repro_torch.optim import adamw
    from repro_torch.train import steps as ST
    t0 = time.perf_counter()
    cfg = configs.get_config(SSM_TP_ARCH)
    tc = ST.TrainConfig(opt=adamw.OptConfig(lr=LM_LR, warmup_steps=1,
                                            total_steps=100))
    hand = hand_count(cfg)
    real = {"train_4k": tp_step(torch, cfg, tc),
            "decode_32k": ep_decode(torch, cfg, tc, ("ssm", "conv"))}
    recs = {shape: tp_record(p) for shape, p in zip(EP_SHAPES, procs)}
    lo, hi = DRYRUN_PEAK_BAND
    out = {"hand": hand}
    for (name, shape) in zip("ab", EP_SHAPES):
        r, rec = real[shape], recs[shape]
        tracked = rec["memory"]["peak_per_device_gb"]
        ratio = r["peak_gb"] / tracked
        print(f"({name}) {cfg.name} L = {cfg.n_layers}, {shape} on rank 0 "
              f"of {TP_MESH}, bf16 [{smi}]: max_memory_allocated "
              f"{r['peak_gb']:.4f} GB against the dry run's tracked peak "
              f"{tracked:.4f} GB (ratio {ratio:.4f}, band {lo}–{hi}; limit "
              f"{TP_LIMIT_GB} GB); wall {r['wall_s']:.4f} s; dry run (CPU "
              f"of this machine, {rec['trace_s']} s): flops "
              f"{rec['roofline']['flops']:.6g}, products "
              f"{rec.get('dot_flops')}, useful-flops ratio "
              f"{rec.get('useful_flops_ratio')}", flush=True)
        print("    collectives by purpose (calls, bytes; the fake group "
              "moves nothing): " + ", ".join(
                  f"{k} {v[0]} ({v[1] / 2**20:.1f} MiB)"
                  for k, v in r["tags"].items()), flush=True)
        assert r["peak_gb"] < TP_LIMIT_GB, (shape, r)
        assert lo <= ratio <= hi, (shape, r["peak_gb"], tracked)
        out[shape] = {"real": r, "tracked_gb": tracked,
                      "flops": rec["roofline"]["flops"],
                      "dot_flops": rec.get("dot_flops"),
                      "useful_flops_ratio": rec.get("useful_flops_ratio")}
    dec = real["decode_32k"]
    print(f"    hand count of (a): products {hand['products']:.6g} (dense "
          f"{hand['dense']:.6g}, attention {hand['attention']:.6g}, head "
          f"{hand['head']:.6g}), saved inputs {hand['saved_inputs_gb']:.4f}"
          f" GB, compute leaves {hand['leaves']} ({hand['leaves_gb']:.4f} "
          f"GB bf16 + f32), masters and moments "
          f"{hand['masters_moments_gb']:.4f} GB; (b)'s Mamba2 caches "
          f"{dec['cache_spec']}, local {dec['cache_local']}, logits "
          f"{dec['logits']}", flush=True)
    tags = real["train_4k"]["tags"]
    for tag in ("mamba", "norm_ss", "region", "grad", "gather"):
        assert tags.get(tag, (0, 0))[0] > 0, (tag, tags)
    assert dec["cache_spec"]["ssm"][1] == pshard.MODEL_AXIS, dec
    assert dec["cache_spec"]["conv"][2] == pshard.MODEL_AXIS, dec
    for tag in ("mamba", "norm_ss", "state", "region"):
        assert dec["tags"].get(tag, (0, 0))[0] > 0, (tag, dec["tags"])
    out["seconds"] = time.perf_counter() - t0
    print(f"    phase 27: {out['seconds']:.2f} s; phase 22's cut of "
          f"zamba2's steps saved "
          + ("(not run)" if trim_s is None else f"{trim_s:.2f} s"),
          flush=True)
    return out


# two fill batches of 8, then a 4-query tail (cut from 44 when phase 24
# came, to keep the smoke within half its limit)
SERVE_QUERIES = 20
# the --solver cd run's queries: one fill batch (cut from 44 to 12, a
# fill batch and a 4-query tail, when phases 17 and 18 came, and to 8
# when phase 24 came: its wide buckets run matvec CD, the slowest arm of
# the smoke). A coarser grid is no cut: its sequential screens keep more
# columns (8 λ of the same span: a timed run of 255 s against 16 λ's
# 40 s, on another card's host)
SERVE_CD_QUERIES = 8
SERVE_ARGV = ["--n", str(MNIST[0]), "--p", str(MNIST[1]), "--nnz", "16",
              "--seed", "0", "--b-max", str(BATCH), "--deadline-ms", "20",
              "--queue-cap", "64", "--max-in-flight", "2", "--num-queries",
              str(SERVE_QUERIES), "--num-lambdas", "16", "--hi-frac", "0.95",
              "--lo-frac", "0.1", "--solver-tol", "1e-6"]


def tail_reason(report) -> str:
    """The reason the loop must give the last, partial batch: "deadline"
    when its oldest query had waited the policy's deadline at dispatch
    (checked first), else "drain" (the source is exhausted)."""
    last = report.trace[-1]
    waited = last.t - min(t.t_admit for t in report.tickets
                          if t.batch_id == last.batch_id)
    return "deadline" if waited >= report.policy.deadline_s else "drain"


def serve_readings(report) -> str:
    s = report.summary()
    return (f"served {s['n_ok']}/{s['n_queries']} in {s['wall_time_s']:.3f} "
            f"s: {s['queries_per_sec']:.2f} queries/sec, latency p50 "
            f"{s['p50_latency_s'] * 1e3:.1f} ms p99 "
            f"{s['p99_latency_s'] * 1e3:.1f} ms, errors {s['n_errors']}, "
            f"unconverged {s['n_unconverged']}, trace "
            + " ".join(f"{r.reason}:{r.n_live}/{r.padded_b}"
                       for r in report.trace))


def serve_phase(torch, tmp: str) -> dict:
    """``repro_torch.launch.serve.main`` in-process at the batched path's
    width: compare mode (both arms served whole, every mask bit for bit the
    direct call, the traces the policy gives), then a continuous ``--solver
    cd`` run, every live step on ``cd_gram_sweep``. Returns the launches of
    each run."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    bench = os.path.join(tmp, "serve.json")
    ops.reset_counts()
    t0 = time.perf_counter()
    out = serve.main([*SERVE_ARGV, "--mode", "compare", "--repeats",
                      "1", "--check-masks", "0", "--bench-json", bench])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                             "fista_step"))
    reps = out["reports"]
    for mode, rep in reps.items():
        print(f"  {mode}: {serve_readings(rep)}")
    print(f"serve compare wall {wall:.2f} s (fit, 2 warm-up and 2 timed "
          f"arms, {2 * SERVE_QUERIES} direct replays); continuous / fixed "
          f"queries/sec {out['ratio']:.3f}; launches "
          + ", ".join(f"{k} {launches[k]}" for k in ops.OPS))
    full = [("fill", BATCH, BATCH)] * (SERVE_QUERIES // BATCH)
    tail = SERVE_QUERIES % BATCH
    want = {"fixed": full + [("drain", tail, BATCH)],
            "continuous": full + [(tail_reason(reps["continuous"]), tail,
                                   tail)]}
    for mode, rep in reps.items():
        s = rep.summary()
        assert s["n_ok"] == s["n_queries"] == SERVE_QUERIES, (mode, s)
        assert s["n_errors"] == 0 and all(t.ok for t in rep.tickets)
        assert [(r.reason, r.n_live, r.padded_b)
                for r in rep.trace] == want[mode], (mode, rep.trace)
    assert os.path.exists(bench)
    # a served query's masks against its direct call: bit for bit except
    # for columns within the rounding band of the threshold (the batch's
    # solve runs on the union bucket, the single one on its own)
    sess = out["session"]
    X64 = sess.X.to(torch.float64)
    flips = band = 0
    worst = 0.0
    for mode, qids in out["mismatched"].items():
        for t in reps[mode].tickets:
            if t.qid in qids:
                f, n_band, w = band_flips(torch, X64, t.y, sess.path(
                    t.y, t.result.lambdas), t.result.masks)
                flips, band, worst = flips + f, band + n_band, max(worst, w)
    print(f"served masks against the direct calls: queries not bit for bit "
          f"{out['mismatched']}; {flips} mask flips, all in the ±{BAND:g} "
          f"band ({band} step-columns of those queries in it), the "
          f"farthest {worst:.3g} from the threshold")
    del X64, sess, out

    ops.reset_counts()
    t0 = time.perf_counter()
    cd = serve.main([*SERVE_ARGV, "--solver", "cd", "--mode",
                     "continuous", "--num-queries", str(SERVE_CD_QUERIES)]
                    )["reports"]["continuous"]
    torch.cuda.synchronize()
    cd_wall = time.perf_counter() - t0
    cd_launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                                "cd_gram_sweep"))
    steps = {id(st): st for t in cd.tickets for st in t.result.stats
             if st.screen_backend}.values()
    # the Gram crossover: a bucket of at most min(n, GRAM_BUCKET_MAX)
    # columns runs on cd_gram_sweep, a wider one on matvec CD (plain torch
    # in both packages)
    limit = min(MNIST[0], ops.GRAM_BUCKET_MAX)
    gram = [st for st in steps if st.bucket <= limit]
    wide = sorted(st.bucket for st in steps if st.bucket > limit)
    print(f"  cd: {serve_readings(cd)}")
    print(f"serve --solver cd wall {cd_wall:.2f} s (fit, a warm-up and a "
          f"timed run); {len(gram)} of {len(steps)} live batch steps with "
          f"union buckets ≤ {limit} columns, all on cd_gram_sweep; the "
          f"other {len(wide)} (buckets {wide}) on matvec CD; launches "
          f"cd_gram_sweep {cd_launches['cd_gram_sweep']}, fista_step "
          f"{cd_launches['fista_step']}")
    assert cd.summary()["n_errors"] == 0 and all(t.ok for t in cd.tickets)
    assert cd.summary()["n_ok"] == SERVE_CD_QUERIES
    assert gram and all(st.gram_step_frac == 1.0 for st in gram)
    assert all(st.gram_step_frac == 0.0 for st in steps
               if st.bucket > limit)
    assert cd_launches["fista_step"] == 0
    return {"launches": launches, "cd_launches": cd_launches}


def solve_phase(torch, tmp: str) -> dict:
    """``repro_torch.launch.solve.main`` in-process: the plain path at the
    main path's width with checkpoints (the last one holds the result's
    last β), and the group path. Returns the launches of each run."""
    from repro_torch.checkpoint import latest_step, restore
    from repro_torch.kernels import ops
    from repro_torch.launch import solve
    ckpt = os.path.join(tmp, "ckpt")
    ops.reset_counts()
    t0 = time.perf_counter()
    n, p = MNIST
    res = solve.main(["--n", str(n), "--p", str(p), "--nnz", "16",
                      "--no-x64", "--num-lambdas", "20", "--ckpt-dir",
                      ckpt])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                             "fista_step"))
    step = latest_step(ckpt)
    tree, extra = restore(ckpt, step, {"beta": 0}, device="cpu")
    same = np.array_equal(tree["beta"].numpy().astype(np.float64),
                          res.betas[-1])
    live = [s for s in res.stats if s.screen_backend]
    print(f"solve wall {wall:.2f} s ({n} × {p}, 20 λ, tol "
          f"1e-8): {sum(s.solver_iters >= 5000 for s in live)} of "
          f"{len(live)} live steps at max_iter; latest checkpoint step "
          f"{step}, its beta equal to the result's last {same}, its λ "
          f"{extra['lam']:.6g}; launches "
          + ", ".join(f"{k} {launches[k]}" for k in ops.OPS))
    assert step == 19 and same and np.isfinite(res.betas).all()
    assert sorted(os.listdir(ckpt)) == [f"step_{k:08d}" for k in (17, 18,
                                                                    19)]
    n_g, p_g, m = GROUP_EXACT
    ops.reset_counts()
    t0 = time.perf_counter()
    res_g = solve.main(["--n", str(n_g), "--p", str(p_g), "--group-size",
                        str(m), "--nnz", "200", "--no-x64", "--num-lambdas",
                        "20"])
    torch.cuda.synchronize()
    g_wall = time.perf_counter() - t0
    g_launches = counted(ops, ("group_screen_scores",))
    print(f"solve --group-size {m} wall {g_wall:.2f} s ({n_g} × {p_g}, 20 "
          f"λ); launches group_screen_scores "
          f"{g_launches['group_screen_scores']}")
    assert res_g.masks.shape == (20, p_g // m)
    assert np.isfinite(res_g.betas).all()
    return {"launches": launches, "group_launches": g_launches,
            "result": res, "group_result": res_g}


def main(argv: list[str]) -> int:
    tree = None
    if len(argv) == 3 and argv[:2] == ["--kernels", "--tree"]:
        tree, argv = os.path.abspath(argv[2]), ["--kernels"]
        sys.path.insert(0, os.path.join(tree, "src"))
    if argv not in ([], ["--faults"], ["--kernels"], ["--lm-lr"],
                    ["--moe"], ["--ssm"], ["--shard"], ["--dryrun"],
                    ["--tp"], ["--ep"], ["--ssm-tp"]):
        print("usage: python3 chip_smoke.py [--faults | --lm-lr | --moe | "
              "--ssm | --shard | --dryrun | --tp | --ep | --ssm-tp | "
              "--kernels [--tree DIR]]", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    load_cost_rules()
    import repro_torch
    from repro_torch import LassoSession, PathConfig, ScreenSpec, SolveSpec
    from repro_torch import kernels
    from repro_torch.data import group_lasso_problem
    from repro_torch.kernels import build, ops, ref

    with phase("environment"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
        print(smi)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} "
              f"count {torch.cuda.device_count()}")
        print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn={torch.backends.cudnn.allow_tf32} "
              f"package {repro_torch.__file__}")
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32

    if argv == ["--lm-lr"]:
        with phase(f"LM learning rates on phase 20's fixed batch "
                   f"({LM_ARCH}, L = {LM_DEPTH})"):
            lm_lr_sweep(torch)
        return 0
    if argv == ["--moe"]:
        with tempfile.TemporaryDirectory() as tmp, phase(MOE_PHASE):
            moe_phase(torch, tmp)
        return 0
    if argv == ["--ssm"]:
        with tempfile.TemporaryDirectory() as tmp, phase(SSM_PHASE):
            clis = start_clis(tmp)
            try:
                ssm_phase(torch, tmp, clis)
            finally:
                stop_all(proc for _, proc in clis[0].values())
        return 0
    if argv == ["--shard"]:
        with tempfile.TemporaryDirectory() as tmp, phase(SHARD_PHASE):
            shard_phase(torch, tmp)
        return 0
    if argv == ["--dryrun"]:
        with tempfile.TemporaryDirectory() as tmp, phase(DRYRUN_PHASE):
            dryrun_phase(torch, smi, tmp)
        return 0
    if argv == ["--tp"]:
        with tempfile.TemporaryDirectory() as tmp, phase(TP_PHASE):
            tp_phase(torch, smi, dryrun_cell_start(tmp, TP_CLI, "dryrun_tp"),
                     None)
        return 0
    if argv == ["--ep"]:
        with tempfile.TemporaryDirectory() as tmp, phase(EP_PHASE):
            procs = ep_cli_start(tmp)
            try:
                ep_phase(torch, smi, procs)
            finally:
                stop_all(proc for _, proc in procs)
        return 0
    if argv == ["--ssm-tp"]:
        with tempfile.TemporaryDirectory() as tmp, phase(SSM_TP_PHASE):
            procs = ssm_tp_cli_start(tmp)
            try:
                ssm_tp_phase(torch, smi, procs)
            finally:
                stop_all(proc for _, proc in procs)
        return 0

    with phase("build"):
        t0 = time.perf_counter()
        logs = build.build_all()
        print(f"nvcc build of {sorted(logs)}: "
              f"{time.perf_counter() - t0:.2f} s")
        ptxas = ptxas_table(logs)
        for name, log in logs.items():       # ptxas -v, per library
            t = ptxas_table({name: log})
            regs = sorted({v[0] for v in t.values()})
            spill = sum(v[1] + v[2] for v in t.values())
            print(f"  {name}: {len(t)} kernels, registers {regs}, spill "
                  f"bytes {spill}")
            for k, (r, st, ld) in sorted(t.items()):
                if st or ld:
                    print(f"    spills {st}/{ld} bytes, {r} registers: {k}")

    if argv == ["--faults"]:
        with phase("fault check of the CD, group and dist_fista checks"):
            fault_check(torch)
        return 0

    rows = {}
    with phase("kernels against their plain versions"):
        one = torch.zeros(1, device="cuda")
        floor_ms = event_ms(torch, lambda: one.zero_())
        print(f"  launch floor (1-element zero_(), CUDA events, median of "
              f"{REPS}): {floor_ms:.4f} ms", flush=True)
        cases = [(op, *MNIST, B) for op in ("edpp_screen_scores",
                                            "screen_matvec") for B in (1, 8)]
        # the *_cut screens' stacked [centre; ĝ] rows: one query (2) and a
        # batch of 8 (16 rows: two launches of MAX_B)
        cases += [("screen_matvec", *MNIST, B) for B in STACKED]
        cases += [(op, *SVHN, 1) for op in ("edpp_screen_scores",
                                            "screen_matvec")]
        cases += [("fista_step", 784, p, B) for p in (32, 512, 4096)
                  for B in (1, 8)]
        cases += [("fista_step", *MNIST, 1)]          # the unscreened arm
        cases += [(op, 777, 1001, 3) for op in ("edpp_screen_scores",
                                                "screen_matvec", "fista_step")]
        for i, case in enumerate(cases):
            rows[case] = check_kernel(torch, kernels, ref, *case, seed=i,
                                      floor_ms=floor_ms, ptxas=ptxas)
        if hasattr(kernels.edpp_screen, "retest_plan"):   # trees with bf16
            # the bf16 screen copy's wide pass: one query, the batch, a
            # batch's stacked cut rows (two launches), the SVHN width
            for i, (nn, pp, B) in enumerate(BF16_CASES):
                rows[("screen_matvec_bf16", nn, pp, B)] = check_kernel(
                    torch, kernels, ref, "screen_matvec", nn, pp, B,
                    seed=160 + i, floor_ms=floor_ms, ptxas=ptxas, bf16=True)
        if "fista_step_bf16" in kernels.edpp_screen._SIGNATURES:
            # fista_step on a bf16 solve bucket: 784 × 32 alone, the
            # batched path's bucket with a (3, B) block (each row the bits
            # of its single launch), a cluster's row split, scalar loads
            for i, (nn, pp, B, blk) in enumerate(BF16_FISTA_CASES):
                rows[("fista_step_bf16", nn, pp, B)] = check_kernel(
                    torch, kernels, ref, "fista_step", nn, pp, B,
                    seed=170 + i, floor_ms=floor_ms, ptxas=ptxas, block=blk,
                    bf16=True)
        if "wide_p" in inspect.signature(
                kernels.edpp_screen_scores).parameters:
            # an update's added block: bench_update's 5 % of 50 000
            rows["wide_fused"] = check_wide_fused(
                torch, kernels, ref, MNIST[0], MNIST[1],
                int(CHURN * MNIST[1]), seed=180, floor_ms=floor_ms,
                ptxas=ptxas)
        choices = [cluster_choice(torch, kernels, ref, 784, pp, B,
                                  seed=90 + B) for pp in (32, 512)
                   for B in (1, 8)]
        step_ns = chain_step_ns(torch, kernels)
        print("  cd chain: one dependent coordinate step "
              + ("n/a (no cd_chain_f32 in this tree)" if step_ns is None
                 else f"{step_ns:.2f} ns ({CHAIN_TURNS} turns of 32 steps, "
                      f"one warp, no loads)"), flush=True)
        for i, (bp, B) in enumerate([(b, B) for b in (32, 256, 1024)
                                     for B in (1, 8)]):
            rows[("cd", bp, B)] = check_cd(torch, kernels, ref, bp, B,
                                           seed=100 + i, step_ns=step_ns,
                                           ptxas=ptxas)
        rows[("cd", 256, 8, "valid")] = check_cd(
            torch, kernels, ref, 256, 8, seed=110, masked=True,
            step_ns=step_ns, ptxas=ptxas)
        n_g, p_g, _ = GROUP_FULL
        for i, m in enumerate((5, 10, 20, 200)):
            rows[("group", n_g, p_g, m)] = check_group(
                torch, kernels, ref, n_g, p_g, m, seed=120 + i, ptxas=ptxas)
        for i, (pp, m) in enumerate(((1000, 5), (1001, 7))):
            rows[("group", 777, pp, m)] = check_group(
                torch, kernels, ref, 777, pp, m, seed=130 + i, ptxas=ptxas)
        if "wide_p" in inspect.signature(
                kernels.group_screen_scores).parameters:
            # a mesh rank's block of whole groups: half of the group design
            rows["wide_group"] = check_wide_group(
                torch, kernels, ref, *GROUP_FULL, seed=135, ptxas=ptxas)
            # a quarter of 250 × 16 800: here the block's own plan splits
            # the rows over a cluster and the whole width's does not
            rows["wide_group_quarter"] = check_wide_group(
                torch, kernels, ref, GROUP_FULL[0], 16800, 10, seed=136,
                ptxas=ptxas, parts=4, must_differ=True)
        # phase 20's bridge: groups of one neuron over yi-9b's d_ff
        rows["group_m1"] = check_group(torch, kernels, ref, LM_PROBE,
                                       LM_WIDTH[4], 1, seed=137, ptxas=ptxas)
        floors = {"alone": floor_ms,
                  "run": run_ms(torch, lambda: one.zero_(), GRAPH_RUN),
                  "graph": graph_ms(torch, lambda: one.zero_(), GRAPH_RUN)}
        print(f"  launch floor per 1-element zero_() in a run of {GRAPH_RUN} "
              f"from Python {floors['run']:.4f} ms, replayed from a graph of "
              f"{GRAPH_RUN} {floors['graph']:.4f} ms", flush=True)
        for i, (pp, B, per_query) in enumerate([(MNIST[1], 1, False),
                                                (MNIST[1], 8, False),
                                                (1003, 3, True)]):
            rows[("prox", pp, B)] = check_prox(torch, kernels.prox_step, ref,
                                               pp, B, per_query, seed=140 + i,
                                               floors=floors)
        if hasattr(kernels.solver_step, "MAX_PARTS"):   # trees with parts
            for i, (pp, B) in enumerate([(MNIST[1], 1), (MNIST[1], 8),
                                         (1003, 3)]):
                rows[("prox_parts", pp, B)] = check_prox(
                    torch, kernels.prox_step, ref, pp, B, True, seed=150 + i,
                    floors=floors, parts=PARTS)
        floor_end = event_ms(torch, lambda: one.zero_())
        print(f"  launch floor again: {floor_end:.4f} ms", flush=True)

    if argv == ["--kernels"]:
        print(json.dumps({"tree": tree or HERE, "launch_floor_ms":
                          [floor_ms, floor_end], "floors": floors,
                          "cluster": choices,
                          "rows": [dict(r, key=str(k))
                                   for k, r in rows.items()]}))
        print(smi)
        return 0

    X, y = make_dataset(*MNIST)
    n, p = MNIST
    with phase("main path: fit + 100-λ path, default config"):
        ops.reset_counts()
        t0 = time.perf_counter()
        sess = LassoSession.fit(X)
        res = sess.path(y, num_lambdas=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                                 "fista_step"))
        assert sess.geometry.X.is_cuda and sess.backend_name == "cuda"
        assert sess.fit_passes == 1, sess.fit_passes
        live = [s for s in res.stats if s.screen_backend]   # λ < λ_max
        assert live and all(s.x_passes == 1 for s in live)
        assert np.isfinite(res.betas).all()
        cfg = sess.config.solve
        at_max = sum(s.solver_iters >= cfg.max_iter for s in live)
        iters = sum(s.solver_iters for s in res.stats)
        print(f"path wall {wall:.2f} s; {len(live)} live steps, all at "
              f"x_passes=1; fit_passes={sess.fit_passes}; steps at "
              f"max_iter={cfg.max_iter} (tol {cfg.tol:g}): {at_max}; "
              f"solver iterations {iters}; query_converged "
              f"{bool(res.query_converged[0])}")
        print("discard fraction per decile of the grid: "
              + deciles(res, p))
        by_bucket: dict[int, int] = {}
        for s in live:
            by_bucket[s.bucket] = by_bucket.get(s.bucket, 0) + s.solver_iters
        print(f"solver iterations per bucket: {dict(sorted(by_bucket.items()))}")
        main_bucket = max(by_bucket, key=by_bucket.get)
        main_launches = dict(launches)

    with phase("exactness: EDPP vs unscreened, tol 1e-6, 20 λ"):
        solve = SolveSpec(tol=1e-6)
        arms = {}
        for rule in ("edpp", "none"):
            sess.reset_solver_cache()
            t0 = time.perf_counter()
            arms[rule] = sess.path(
                y, num_lambdas=20, hi_frac=0.95,
                config=PathConfig(screen=ScreenSpec(rule=rule), solve=solve))
            at_max = sum(s.solver_iters >= solve.max_iter
                         for s in arms[rule].stats)
            print(f"  {rule}: {time.perf_counter() - t0:.2f} s, "
                  f"converged {bool(arms[rule].query_converged[0])}, "
                  f"steps at max_iter {at_max}")
        none_arm = arms["none"]
        b_e, b_n = arms["edpp"].betas[0], arms["none"].betas[0]
        err, tol = float(np.abs(b_e - b_n).max()), beta_err_tol(y, 1e-6)
        unsafe = int((arms["edpp"].masks[0]
                      & (np.abs(b_n) > 1e-6 * np.abs(b_n).max())).sum())
        print(f"max|beta_edpp - beta_none| = {err:.3g} (tol {tol:.3g}); "
              f"unsafe discards {unsafe}; mean discard fraction "
              f"{arms['edpp'].masks[0].mean():.4f}")
        assert err <= tol and unsafe == 0

    with phase("CD path: fit + 100-λ EDPP path, strategy='cd', tol 1e-6"):
        cd_cfg = PathConfig(solve=SolveSpec(strategy="cd", tol=1e-6))
        ops.reset_counts()
        t0 = time.perf_counter()
        cd_sess = LassoSession.fit(X, config=cd_cfg)
        res_cd = cd_sess.path(y, num_lambdas=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cd_launches = counted(ops, ("edpp_screen_scores", "screen_matvec",
                                    "cd_gram_sweep"))
        live = [s for s in res_cd.stats if s.screen_backend]
        max_epochs = cd_cfg.solve.max_iter // 10 + 1
        at_max = sum(s.solver_iters >= max_epochs for s in live)
        gram = sum(s.gram_step_frac == 1.0 for s in live)
        by_bucket = {}
        for s in live:
            by_bucket[s.bucket] = by_bucket.get(s.bucket, 0) + s.solver_iters
        cd_bucket = max(by_bucket, key=by_bucket.get)
        print(f"CD path wall {wall:.2f} s; {len(live)} live steps, {gram} "
              f"on the Gram system; steps at max_epochs={max_epochs}: "
              f"{at_max}; sweeps per bucket {dict(sorted(by_bucket.items()))}"
              f"; query_converged {bool(res_cd.query_converged[0])}")
        print("discard fraction per decile of the grid: "
              + deciles(res_cd, p))
        assert np.isfinite(res_cd.betas).all() and gram > 0
        t0 = time.perf_counter()
        res_fi = cd_sess.path(y, num_lambdas=100, config=PathConfig(
            solve=SolveSpec(tol=1e-6)))
        r = cd_readings(res_cd, res_fi, max_epochs)
        fails = cd_failures(r, y)
        print(f"FISTA EDPP path at tol 1e-6: {time.perf_counter() - t0:.2f} "
              f"s; max|beta_cd - beta_fista| = {r['err']:.3g} (limits "
              f"{beta_err_tol(y, 1e-6):.3g} and {CD_REL_TOL:g}·max|beta_"
              f"fista| = {CD_REL_TOL * r['scale']:.3g}); failures {fails}")
        assert not fails, fails

    with phase("distributed: NCCL world of 1, (1, 1) mesh, 784 × 50 000"):
        dist_launches = distributed_phase(torch, X, y)

    del X, y, res, res_cd, res_fi
    with phase(f"batched path: QueryStream B={BATCH}, 784 × 50 000, 100 λ, "
               f"FISTA and CD, tol 1e-6"):
        batched = batched_phase(torch)

    del sess, cd_sess
    n_g, p_g, m = GROUP_FULL
    X, y, _ = group_lasso_problem(n_g, p_g, m, active_groups=200, seed=0,
                                  dtype=np.float32)
    units = p_g // m
    with phase(f"group path: fit(groups={m}) + 100-λ group EDPP, tol 1e-6, "
               f"{n_g} × {p_g}"):
        g_cfg = PathConfig(solve=SolveSpec(tol=1e-6))
        ops.reset_counts()
        t0 = time.perf_counter()
        g_sess = LassoSession.fit(X, groups=m, config=g_cfg)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        g_sess.reset_solver_cache()        # phase 19(a) starts alike
        res_g = g_sess.path(y, num_lambdas=100)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        group_launches = counted(ops, ("group_screen_scores",))
        live = [s for s in res_g.stats if s.screen_backend]
        at_max = sum(s.solver_iters >= g_cfg.solve.max_iter for s in live)
        buckets = sorted({s.bucket // m for s in live})
        print(f"group path wall {wall:.2f} s (fit, spectral norms of "
              f"{units} groups: {fit_s:.2f} s); {len(live)} live steps; "
              f"steps at max_iter={g_cfg.solve.max_iter}: {at_max}; "
              f"solver iterations {sum(s.solver_iters for s in live)}; "
              f"buckets (groups) {buckets}; query_converged "
              f"{bool(res_g.query_converged[0])}")
        print("group discard fraction per decile of the grid: "
              + deciles(res_g, units))
        assert np.isfinite(res_g.betas).all()
        assert g_sess.fit_passes == 1 and g_sess.backend_name == "cuda"
        assert all(s.x_passes == 1 for s in live)
    # phase 19(a) holds the group mesh session to this path
    group_full = {"X": X, "y": y, "res": res_g, "wall": wall,
                  "fit_s": fit_s,
                  "spec": g_sess.geometry.spec_norms.cpu()}
    del g_sess, res_g

    n_e, p_e, m = GROUP_EXACT
    X, y, _ = group_lasso_problem(n_e, p_e, m, active_groups=20, seed=0,
                                  dtype=np.float32)
    with phase(f"group exactness: EDPP and strong vs unscreened, tol 1e-6, "
               f"20 λ, {n_e} × {p_e}, m = {m}"):
        e_sess = LassoSession.fit(X, groups=m)
        arms = {}
        for rule in ("none", "edpp", "strong"):
            e_sess.reset_solver_cache()
            ops.reset_counts()
            t0 = time.perf_counter()
            # the screened arms solve on the unscreened arm's grid
            grid = arms["none"].lambdas[0] if arms else None
            arms[rule] = e_sess.path(y, grid, num_lambdas=20, hi_frac=0.95,
                                     config=PathConfig(
                                         screen=ScreenSpec(rule=rule),
                                         solve=SolveSpec(tol=1e-6)))
            counted(ops, () if rule == "none" else ("group_screen_scores",))
            st = arms[rule].stats
            print(f"  {rule}: {time.perf_counter() - t0:.2f} s, converged "
                  f"{bool(arms[rule].query_converged[0])}, steps at max_iter "
                  f"{sum(s.solver_iters >= 5000 for s in st)}, kkt rounds "
                  f"{sum(s.kkt_rounds for s in st)}")
        for rule in ("edpp", "strong"):
            r = group_readings(arms[rule], arms["none"], m)
            fails = group_failures(r, y)
            print(f"group {rule}: max|beta - beta_none| = {r['err']:.3g} "
                  f"(limits {beta_err_tol(y, 1e-6):.3g} and "
                  f"{GROUP_REL_TOL:g}·max|beta_none| = "
                  f"{GROUP_REL_TOL * r['scale']:.3g}); unsafe group discards "
                  f"{r['unsafe']}; mean discard fraction {r['discard']:.4f}; "
                  f"failures {fails}")
            assert not fails, fails
        # a (2, n) group batch against its two single runs, in the same
        # order from the same cold eigenvector cache: the same bits
        rng = np.random.default_rng(1)
        w = np.zeros(p_e)
        for g in rng.choice(p_e // m, 20, replace=False):
            w[g * m:(g + 1) * m] = rng.uniform(-1.0, 1.0, m)
        Y2 = np.stack([y, (X @ w + 0.1 * rng.standard_normal(n_e))
                       .astype(np.float32)])
        g_cfg = PathConfig(solve=SolveSpec(tol=1e-6))
        e_sess.reset_solver_cache()
        ops.reset_counts()
        res2 = e_sess.path(Y2, num_lambdas=20, hi_frac=0.95, config=g_cfg)
        counted(ops, ("group_screen_scores",))
        e_sess.reset_solver_cache()
        ones = [e_sess.path(Y2[b], res2.lambdas[b], config=g_cfg)
                for b in range(2)]
        equal = [np.array_equal(res2.masks[b], ones[b].masks[0])
                 and np.array_equal(res2.betas[b], ones[b].betas[0])
                 for b in range(2)]
        print(f"group batch (2, {n_e}): masks and betas bit for bit its two "
              f"single runs {equal}; query_converged "
              f"{res2.query_converged.tolist()}; batch_size "
              f"{res2.stats[-1].batch_size}")
        assert all(equal) and res2.betas.shape == (2, 20, p_e)
        assert all(s.batch_size == 2 for s in res2.stats)

    with tempfile.TemporaryDirectory() as tmp:
        with phase(f"serve: repro_torch.launch.serve.main, compare then "
                   f"--solver cd, {SERVE_QUERIES} queries, {n} × {p}, "
                   f"B_max {BATCH}, 16 λ"):
            served = serve_phase(torch, tmp)
        with phase(f"solve: repro_torch.launch.solve.main, {n} × {p} with "
                   f"checkpoints and {n_e} × {p_e} groups of {m}, 20 λ"):
            solved = solve_phase(torch, tmp)

    X, y = make_dataset(*MNIST)
    with phase(f"rules: the other screening rules, {n} × {p}"):
        rules = rules_phase(torch, X, y, none_arm)
    rules_launches = rules["launches"]
    for op, k in dist_launches["rules"].items():
        rules_launches[op] += k
    with phase(f"bf16 screen: screen_dtype='bfloat16', {n} × {p}"):
        bf16 = bf16_phase(torch, X, y, rules, solved)
    with phase(f"bf16 solve: solve_dtype='bfloat16', {n} × {p}"):
        bf16_solve = bf16_solve_phase(torch, X, y, solved)
    with phase(f"mesh bf16: NCCL world of 1, (1, 1) mesh, {n} × {p}"):
        mesh_bf16 = mesh_bf16_phase(torch, X, y, solved)
    with phase(f"updates: session.update at {n} × {p}, {CHURN:.0%} churn"):
        updates = update_phase(torch, X, y)
    with phase(f"group mesh and the core surface: NCCL world of 1, "
               f"{GROUP_FULL[0]} × {GROUP_FULL[1]} groups of "
               f"{GROUP_FULL[2]} and {n} × {p}"):
        group_mesh = group_mesh_phase(torch, group_full, solved, X, y)
    del X, y, none_arm, rules, group_full
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        # phases 20(d) and 21(c), the --tiny CLI runs, and phase 24(d),
        # the dry run's CLI cells, start here and run beside phase 20's
        # steps and checkpoint; phase 22(d)'s CLI runs and phase 23(b)'s
        # torchrun start before phase 22 and run beside it
        clis = {a: start_cli(a, tmp) for a in (LM_ARCH, MOE_CLI_ARCH)}
        dry_procs = dryrun_cli_start(tmp)
        tp_proc = dryrun_cell_start(tmp, TP_CLI, "dryrun_tp")
        ep_procs = ep_cli_start(tmp)
        ssm_tp_procs = ssm_tp_cli_start(tmp)
        later = [tp_proc[1]] + [proc for _, proc in ep_procs + ssm_tp_procs]
        try:
            with phase(f"LM stack: {LM_ARCH} at full width, L = {LM_DEPTH}, "
                       f"seq {LM_SEQ}, batch {LM_BATCH}; the FFN bridge"):
                lm = lm_phase(torch, tmp, clis[LM_ARCH])
            with phase(MOE_PHASE):
                moe_phase(torch, tmp, clis[MOE_CLI_ARCH])
            ssm_clis = start_clis(tmp)
            later += [proc for _, proc in ssm_clis[0].values()]
            run = torchrun_start(tmp)
            later.append(run[1])
            with phase(SSM_PHASE):
                ssm = ssm_phase(torch, tmp, ssm_clis)
            with phase(SHARD_PHASE):
                shard = shard_phase(torch, tmp, run)
            with phase(DRYRUN_PHASE):
                dryrun_phase(torch, smi, tmp, dry_procs)
            with phase(TP_PHASE):
                tp_phase(torch, smi, tp_proc, shard)
            with phase(EP_PHASE):
                ep_phase(torch, smi, ep_procs)
            with phase(SSM_TP_PHASE):
                ssm_tp_phase(torch, smi, ssm_tp_procs, ssm.get("trim_s"))
        finally:
            stop_all([c[1] for c in clis.values()]
                     + [d[1] for d in dry_procs] + later)

    with phase(f"kernels at the paths' shapes (fista bucket {main_bucket}, "
               f"cd bucket {cd_bucket}; batched B={BATCH}: fista bucket "
               f"{batched['bucket']}, cd bucket {batched['cd_bucket']})"):
        rows["main_fista"] = check_kernel(torch, kernels, ref, "fista_step",
                                          n, main_bucket, 1, seed=99,
                                          floor_ms=floor_ms, ptxas=ptxas)
        rows["main_cd"] = check_cd(torch, kernels, ref, cd_bucket, 1,
                                   seed=98, step_ns=step_ns, ptxas=ptxas)
        rows["batch_fista"] = check_kernel(
            torch, kernels, ref, "fista_step", n, batched["bucket"], BATCH,
            seed=97, floor_ms=floor_ms, ptxas=ptxas, block=True)
        rows["batch_cd"] = check_cd(torch, kernels, ref,
                                    batched["cd_bucket"], BATCH, seed=96,
                                    masked=True, step_ns=step_ns, ptxas=ptxas)
    main_launches.update(cd_gram_sweep=cd_launches["cd_gram_sweep"],
                         group_screen_scores=group_launches[
                             "group_screen_scores"],
                         prox_step=dist_launches["prox_step"])
    summary = []
    for op, key in (("edpp_screen_scores", ("edpp_screen_scores", *MNIST, 1)),
                    ("screen_matvec", ("screen_matvec", *MNIST, 1)),
                    ("fista_step", "main_fista"),
                    ("cd_gram_sweep", "main_cd"),
                    ("group_screen_scores", ("group", *GROUP_FULL)),
                    ("prox_step", ("prox_parts", MNIST[1], 1))):
        r = rows[key]
        summary.append({
            "name": op, "route": "cuda", "source": SOURCES[op],
            "replaces": REPLACES[op], "launches": main_launches[op],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # torch.matmul(c, X) computes screen_matvec's function exactly;
            # torch.sum(parts, 0) the prox step's sum of its parts (not the
            # prox); the other four have no single library call
            "library_ms": (r["matmul_ms"] if op == "screen_matvec" else
                           r.get("library_ms")),
            **({"chain_bound_ms": r["chain_ms"]}
               if op == "cd_gram_sweep" else {}),
            **({"graph_ms": r["graph_ms"], "run_ms": r["run_ms"],
                "parts": r["parts"]} if op == "prox_step" else {}),
            **batch_entry(op, rows, batched),
            # the *_cut screens' stacked matvecs (phase 3)
            **({"stacked": [stacked_entry(rows[("screen_matvec", *MNIST, B)])
                            for B in STACKED]}
               if op == "screen_matvec" else {}),
            # every counted arm of the rules phase and its mesh arms
            "rules_launches": rules_launches[op],
            # the serve phase's compare run (fit, four arms, the direct
            # replays) and, for cd_gram_sweep, its --solver cd run
            "serve_launches": served["launches"][op],
            **({"serve_cd_launches": served["cd_launches"][op]}
               if op == "cd_gram_sweep" else {}),
            "solve_launches": (solved["group_launches"] if op ==
                               "group_screen_scores" else
                               solved["launches"])[op],
            # phase 17's mesh arms (bf16 screen and solve, single, cd and
            # the batch, and its solve --mesh 1x1) and phase 18's updates
            "mesh_bf16_launches": mesh_bf16["total"].get(op, 0),
            "update_launches": updates["launches"].get(op, 0),
            # phase 19: (a) the group mesh session's 100-λ path, (d) the
            # one-shot fista
            "group_mesh_launches": group_mesh["mesh"].get(op, 0),
            "one_shot_launches": group_mesh["one_shot"].get(op, 0),
            # phase 20(e): the FFN bridge's group-EDPP path (m = 1)
            "lm_bridge_launches": lm["bridge"].get(op, 0),
            # the fused pass over an update's added block, wide_p = p
            **({"wide_plan": {k: rows["wide_fused"][k] for k in (
                "n", "p", "wide_p", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "bitwise")}}
               if op == "edpp_screen_scores" and "wide_fused" in rows
               else {}),
            # the group pass on a mesh rank's block, wide_p = p (phase 3)
            **({key: {k: rows[row][k] for k in (
                "n", "p", "wide_p", "m", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "bitwise", "own_plan_same_bits",
                "wide_plan", "own_plan")}
                for key, row in (("wide_plan", "wide_group"),
                                 ("wide_plan_quarter",
                                  "wide_group_quarter"))
                if row in rows}
               if op == "group_screen_scores" else {}),
            # the group pass at m = 1 on the bridge's shape (phase 3)
            **({"m1_row": {k: rows["group_m1"][k] for k in (
                "n", "p", "m", "max_abs_err", "ms", "plain_ms", "matmul_ms",
                "bound_ms", "bound_by", "plan")}}
               if op == "group_screen_scores" else {})})
    # the bf16 screen copy's wide pass (the same kernel source, its bf16
    # instantiation): its launches on the 100-λ bf16 EDPP path, its row at
    # 784 × 50 000 with one query, and the batch, stacked and SVHN rows
    r = rows[("screen_matvec_bf16", *MNIST, 1)]
    summary.append({
        "name": "screen_matvec_bf16", "route": "cuda",
        "source": SOURCES["screen_matvec"],
        "replaces": REPLACES["screen_matvec"],
        "launches": bf16["main"].get("screen_matvec_bf16", 0),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        # torch.matmul(c.bfloat16(), X̂): a bf16 product (bf16 output)
        "library_ms": r["matmul_ms"],
        "rows": [stacked_entry(rows[("screen_matvec_bf16", *case)])
                 | {"shape": list(case[:2])} for case in BF16_CASES],
        "phase_launches": bf16["total"].get("screen_matvec_bf16", 0),
        # phase 17: the mesh's bf16 EDPP path, and every mesh arm
        "mesh_launches": mesh_bf16["screen"].get("screen_matvec_bf16", 0),
        "mesh_bf16_launches": mesh_bf16["total"].get("screen_matvec_bf16",
                                                     0)})
    # fista_step on the bf16 solve bucket (the same source, its bf16
    # instantiation): its launches on phase 16's 100-λ bf16-solve EDPP
    # path, its row at 784 × 32 with one query, and the other phase-3 rows
    r = rows[("fista_step_bf16", 784, 32, 1)]
    summary.append({
        "name": "fista_step_bf16", "route": "cuda",
        "source": SOURCES["fista_step"], "replaces": REPLACES["fista_step"],
        "launches": bf16_solve["main"].get("fista_step_bf16", 0),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "floor_ms": r["floor_ms"],
        # no single call computes the fused step; torch.matmul(
        # r.bfloat16(), X̂) is the gradient's product alone
        "library_ms": None, "matmul_ms": r["matmul_ms"],
        "rows": [{k: r[k] for k in (
            "B", "params_block", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "matmul_ms", "floor_ms")}
            | {"shape": [r["n"], r["p"]],
               "rows_bitwise": r.get("rows_bitwise")}
            for r in (rows[("fista_step_bf16", *case[:3])]
                      for case in BF16_FISTA_CASES)],
        "phase_launches": bf16_solve["total"].get("fista_step_bf16", 0),
        # phase 17: the mesh's bf16-solve EDPP path, and every mesh arm
        "mesh_launches": mesh_bf16["solve"].get("fista_step_bf16", 0),
        "mesh_bf16_launches": mesh_bf16["total"].get("fista_step_bf16", 0)})
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
