#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one
``nvcc`` per source, in parallel), then:

1. prints the card (``nvidia-smi``), torch and CUDA versions;
2. holds every kernel against its plain PyTorch version on the card at
   the main path's shapes, in float64 (rtol 1e-12 / atol 1e-9, equal
   sweeps and convergence) and float32 (rtol 2e-5 / atol 1e-2), and
   times kernel and plain version with CUDA events: the max-plus scan at
   1,600,000 and 100,000 elements and (16, 100,000), also held against
   the host's sequential float64 loop and timed beside the same scan as
   ``torch.cumsum`` + ``torch.cummax`` (the library yardstick, with its
   float64 error); the fixpoint at the programs of phases 4, 3, 5 and 13
   with their sweep budgets (8, 8, 64, 8), with each solve's device
   kernels counted by ``torch.profiler`` (one a solve, or the script
   fails); each line gives the kernel's device time, grid and
   registers; and the stacked fixpoint (``zns_fixpoint_sharded``, every
   shard of a plan in one launch) on the signature plans of phases 13
   (16 shards) and 5 (2 shards), shard by shard against its plain
   version and against the single-program kernel (completions, sweeps,
   convergence), timed beside the single-program kernel on the whole
   program, with its launch shape (``stack_launch``: instance, cluster
   size, clusters, rounds; phase 13's plan must take the cluster
   instance);
3. runs the README ``ZnsDevice`` quickstart (200,100 requests);
4. runs the README fleet quickstart (16 devices, 1,600,000 events);
5. runs a contended heterogeneous fleet (``ours`` / ``nvmevirt`` /
   ``femu``; multi-class append pools with resets, 120,600 events);
6. runs ``ZnsDevice.sequential_completions`` on a 100,000-request zone
   chain and ``DeviceFleet.sequential_completions`` on 16 ragged rows;
7. runs ``greedy_generate`` on qwen3-4b at full width and depth (36
   layers, random weights from seed 0): 2 prompts of 1,024 tokens, 16 new
   tokens, then the same prefill with the kernels' plain versions and in
   float32, and times prefill and decode;
8. runs the continuous-batching driver ``repro_torch.launch.serve`` on
   qwen3-4b (16 requests, batch 4, max_seq 128, 32 new tokens);
9. runs ``greedy_generate`` on mamba2-370m at full width and depth (48
   layers, random weights from seed 0): 4 prompts of 2,000 tokens (not a
   multiple of the chunk of 128: the padded path), 16 new tokens, then
   the same prefill with the kernels' plain versions and in float32, and
   times prefill and decode;
10. the same on recurrentgemma-9b at full width and depth (38 blocks,
   9.6e9 float32 parameters): 2 prompts of 3,072 tokens, longer than the
   window of 2,048; then again from every weight matrix N(0, 0.02)
   (phase "10b"), its bfloat16 whole-model last logits held kernels
   against plain versions at ``LOGITS_ATOL``;
11. runs the serving driver on mamba2-370m (16 requests, batch 4,
   max_seq 128, 32 new tokens);
12. solves the 18 cells of the exactness matrix
   (``repro_torch.core.exactness``: 3 workloads x {jitter-free,
   jittered} x the ``cols`` / ``rows`` / ``sharded`` layouts) with the
   ``cuda`` driver (the sharded cells on the ``mesh`` executor), each
   exact, converged and within rtol 1e-9 / 1e-8 of the event engine;
13. runs the experiment runner, ``ExperimentRunner(backend="vectorized",
   device="cuda").run()``: all 15 paper observations as one
   ``DeviceFleet`` call (46 members, 14 family blocks) solved by one
   launch of the fixpoint kernel (one launch in each run, and
   ``torch.profiler`` sees exactly one ``fp_solve_kernel`` in a run, the
   most of 3 profiled runs), every observation passed and converged, every
   metric within rtol 1e-9 of ``results/experiments/obs*.json``
   (``oracle_max_rel_diff`` absolutely, <= 1e-9) and every check's name
   and verdict the fixture's; it times the run, a second (cached) run
   and the solve, and then runs ``python -m repro_torch.experiments run
   --all --out build/experiments``, which must exit with 0;
14. runs ``repro_torch.host.compare_policies(device="cuda")`` at scale
   1.0: 9 (scenario, policy) combinations, 41,093 requests, as one
   ``DeviceFleet`` call and one launch of the fixpoint kernel, every row
   within rtol 1e-9 of the port's host ``event`` backend with the same
   ranking; the three ``tests/golden/*__greedy-open.json`` workloads
   reproduce (trace digest) and their completions hold on the card's
   vectorized backend (rtol 1e-9, atol 1e-6); then ``python -m
   repro_torch.experiments host --out build/host`` must exit with 0;
15. solves the programs of phases 13 and 5 with ``fixpoint="sharded"``
   (the mesh executor: one stacked launch each) against
   ``fixpoint="cuda"`` at rtol 1e-12, and the 1,000,000-request
   open-loop entry of ``benchmarks/mega_fleet.py``'s windowed row
   windowed at 131,072 events (8 windows, 8 launches of the fixpoint
   kernel) against its unwindowed ``cuda`` solve at rtol 1e-12, with
   each one's time and peak device memory; then that one-entry program
   with ``fixpoint="sharded"`` (a 1-shard plan: one launch of the
   single-program kernel) against ``cuda`` at rtol 1e-12;
16. runs ``greedy_generate`` on qwen2-moe-a2.7b at full width and depth
   (24 layers, 60 routed experts top-4 and a shared expert, 14.3e9
   float32 parameters from seed 0): 2 prompts of 1,024 tokens, 16 new
   tokens, as phase 7; counts the (token, expert) routing choices that
   differ between the kernels' and the plain versions' prefills, holds
   the first four layers one by one (below), then runs the serving
   driver on it (16 requests, batch 4, max_seq 128, 32 new tokens);
17. runs the ZNS checkpoint store (``repro_torch.runtime``) on the card:
   the four write policies of ``examples/zns_checkpointing.py`` on a
   4 GiB shard through ``ZnsHostDevice.simulate_payload_write`` (one
   launch of the scan kernel each; 1,048,576 appends at 4 KiB) within
   1e-12 relative of the same call on the CPU, the R5 reset-under-I/O row,
   then ``ZonedCheckpointStore(n_hosts=4)`` under ``build/`` saving
   mamba2-370m's full-size parameters (1.47 GB): one launch of the
   batched scan kernel, a manifest (bytes, zones, sha256, modeled
   seconds) equal to the same save on the CPU, a bit-exact restore, a
   second save and ``gc(keep_last=1)``; the directory is removed;
18. trains tinyllama-1.1b at full width and depth (22 layers, 1.1e9
   float32 parameters from seed 0, every weight matrix N(0, 0.02),
   bfloat16 activations, remat full) through ``repro_torch.launch.train``:
   8 steps of 4 x 2,048 tokens from ``TokenPipeline`` at lr 3e-3 with 2
   warmup steps; every loss finite and the mean of the last 2 below the
   first 2's; each kernel launched exactly as a step needs (forward
   RMSNorm and attention for each layer forward and recompute,
   ``models.common.layer_forward_runs``; each backward once a layer)
   and no other kernel; it prints the step time, tokens/s, peak memory,
   and a profiled step's device idle share, kernel groups (which must
   include both backward kernels) and the attention backward's share of
   the kernels' time.  Then the first step's gradients at full width and
   depth in float32, kernels against plain versions, each leaf's error
   to a float64 plain step within the plain float32 step's plus
   ``GRAD_F64_FRAC`` of its scale, and in bfloat16 each leaf's relative
   (Frobenius) gap, kernels against plain, within ``BF16_GRAD_REL``;
   then at full width and 2 layers a checkpoint at step 3 into the ZNS
   store (one batched scan launch), restored into a fresh state (seed
   99) and replayed through step 6: parameters, m and v equal an
   uninterrupted run's bit for bit;
19. runs the cluster tier (``repro_torch.cluster``) on the card at
   ``benchmarks/cluster_bench.py``'s rack: 4 gateways, 16 storage
   servers, the configs ``ec2+1/round-robin``, ``rep2-k2/hashed``,
   ``ec4+2/strided`` and ``ec3+1/grouped``, 8 users x 6 objects of 1 MiB
   (GET fraction 0.5, seed 0).  ``plan_capacity`` with the users ladder
   [4, 8] and degraded mode (16 programs, 17,164 events) on the default
   ``fixpoint="auto"``: every solve (each compile's bootstrap and
   refinements, and the fleet solve) one launch of the fixpoint kernel,
   as many launches as ``solve_program`` calls; every point converged,
   every config order-stable; each compiled program, family and FIFO pop
   order equal to the same call on ``device="cpu"`` with the host float64
   ``fixpoint="loop"`` driver and numpy scans, its completions within
   rtol 1e-12; the per-op latencies of the fleet solve within
   ``CLUSTER_TOL_US`` of the greedy-engine oracle ``simulate_graph`` on
   each graph; and the bench's ranking sanity (no erasure config's
   degraded p99 below 0.95 of its normal row's).  Then the rate ladder
   [4,000, 16,000, 64,000] objects/s cold and with ``warm_ladder=True``
   (equal curves to rtol 1e-12; it prints warm hits / attempts), and one
   config with ``fixpoint="loop"`` (the batched scan kernel around the
   host loop) against the ``cuda`` driver at rtol 1e-12.  It prints each
   call's wall time split into host lowering and the time inside
   ``solve_program`` (uploads, the launch and the copy back), the solve
   and launch counts, the sweeps and family blocks x sweeps of its
   solves, the fleet solve's programs, events and sweeps, and, from a
   profiled users-ladder call, the device's idle share and the fixpoint
   kernel's device time a launch and a family block a sweep;
20. runs ``greedy_generate`` on musicgen-large at full width and depth (48
   layers, 3.25e9 float32 parameters from seed 0, every weight matrix
   N(0, 0.02)) on (B, S, 4) codebook prompts: 2 prompts of 1,024 frames,
   16 new frames, as phase 7, and holds the last logits of all four
   codebooks, kernels against plain versions, at ``LOGITS_ATOL``
   (bfloat16) and ``F32_LOGITS_ATOL`` (the float32 model);
21. the same on internvl2-26b (48 layers, 19.9e9 parameters from N(0,
   0.02) in the reference's bfloat16 ``param_dtype``, 39.8 GB; its
   float32 model is float32 activations over the bfloat16 weights): the
   text prompt, then an image prompt (stub patch embeddings (2, 256,
   6,144) from ``default_rng(0)``, in bfloat16, over the first 256
   positions) through ``make_prefill_step`` and 8 steps of
   ``make_serve_step``.  For both prompts the float32 model's last
   logits are held kernels against plain versions at
   ``F32_LOGITS_ATOL``; the bfloat16 model's are not comparable between
   two implementations at ``LOGITS_ATOL`` (each MLP's 16,384 bfloat16
   products turn one-step input differences into ~0.1, and both
   bfloat16 models end ~0.8 from the float32 model), so each is held
   against the float32 model's: the kernels' no farther than the plain
   versions' plus ``LOGITS_ATOL``; and each of the 48 layers (image
   prompt, from the plain chain's input) against the layer in float32,
   within the plain versions' error plus ``BF16_BLOCK_TOL``.  Then the
   serving driver on it (bfloat16 weights; 16 requests, batch 4, max_seq
   128, 32 new tokens);
22. trains musicgen-large at full width and depth through
   ``repro_torch.launch.train`` (N(0, 0.02), bfloat16 activations, remat
   full): 4 steps of 4 x 2,048 frames x 4 codebooks, every loss finite,
   each kernel launched exactly as a step needs and no other; it prints
   the step time, frames/s, peak memory, a profiled step's idle share
   and kernel groups; then the first step's bfloat16 gradients at full
   width and 2 layers, kernels against plain versions, each leaf
   (``codebook_embed`` and ``codebook_head`` among them) within
   ``BF16_GRAD_REL``;
23. trains mamba2-370m at full width and depth (48 layers) the same way:
   4 steps of 4 x 2,048 tokens, the losses finite and falling, the SSD
   scan (all on its tensor-core instance), its backward and the norms
   launched exactly as ``layer_forward_runs`` says (the backward all on
   its tensor-core instance); step time, tokens/s, peak memory, idle
   share and kernel groups; then the first step's gradients at full
   width and 2 layers: float32 kernels against a float64 plain step
   (within the plain float32 step's error plus ``GRAD_F64_FRAC`` of each
   leaf's scale, as phase 18) and bfloat16 kernels against plain versions
   (``BF16_GRAD_REL``); then the same at all 48 layers (the float64
   step's peak printed), the bfloat16 gap printed, not held;
24. the same on recurrentgemma-9b at full width cut to 6 layers (two
   (rec, rec, attn) groups, 3.28e9 parameters with the untied embedding
   and head, 52.5 GB of float32 state with AdamW; the 38 blocks fit no
   card) on 1 x 4,096 tokens, so that the window of 2,048 masks: the
   linear recurrence's backward and the attention backward at D 256 with
   the window and MQA (16/1 heads); the gradients checked at one group
   (3 layers: 2 layers would hold no attention block) on 2,304 tokens;
25. ``repro_torch.distributed`` on four ranks that share the card: four
   processes (``spawn``) on ``gloo`` with CUDA tensors (NCCL takes one
   GPU a rank), float32 with TF32 off unless stated; in 25a-25f each
   rank holds the global tensors and cuts its block
   (``distributed.mesh.shard_map``), in 25h, 25k and 25j only its
   blocks of the state, in 25h-25l only its rows of the batch, in 25k,
   25i, 25l and 25j only its blocks of the heads, MLP columns and
   vocabulary (and in 25l of the RG-LRU's channels, in 25j of the
   experts).
   25a ring attention at qwen3-4b's attention shape (2 x 32/8 heads x
   4,096, D 128, causal) on meshes (1, 4) and (2, 2) ("data", "model")
   against the plain attention (``kernels.ref``) at 1e-4 on rank 0, its
   gradient of sum(out^2) through the ring against the plain one's, and
   once in bfloat16 against float32; 25b qwen3-4b at full width cut to 4
   layers (N(0, 0.02) weights, 2 x 2,048 tokens) with
   ``ring_attention=True`` under ``ctx.axis_rules`` on (2, 2) against
   the same ranks' forward with no context (the flash-attention kernel);
   25c flash-decode at qwen3-4b's decode cache (4 x 8 KV heads x 4 x
   32,768, D 128, pos 30,000) on (1, 4) against dense masked attention;
   25d expert-parallel MoE at qwen2-moe-a2.7b's full width cut to 2
   layers (4 x 512 tokens, capacity factor 8) on (2, 2) against
   ``moe_ffn`` on the same weights, with the dropped count and the aux
   losses; 25e GPipe: 4 stages of 2 qwen3-4b decoder layers at full
   width, 4 microbatches of 1 x 1,024, forward and the gathered gradient
   against the sequential stack's autograd on rank 0; 25f the
   error-feedback compressed psum (bf16, int8) over a pod axis of 4 on
   tinyllama-1.1b's embedding and one decoder layer's leaves against
   ``compressed_psum_reference``, and 30 int8 steps' drift; 25h
   tinyllama-1.1b at full width and depth trained three steps on (2, 2)
   with rank-local state under ``RL_RULES`` (FSDP over both axes, nothing
   on "model"; ``distributed.rank_local``: each rank holds only its
   blocks of params, ``m`` and ``v``, gathers a layer's weights whole
   where the step reads them, computes its 2 of the 4 rows and sums the
   gradient over "data") as phase 18 trains it (seed
   0, N(0, 0.02), bfloat16 activations, remat full, 4 x 2,048 tokens
   from ``TokenPipeline``, lr 3e-3 with 2 warmup steps), the losses of
   steps 1-2 and every gradient norm against phase 18's within
   ``RL_LOSS_REL`` and ``RL_NORM_REL`` (step 3 is the first whose weights
   an update moved: its loss is printed), every loss and norm against
   phase 18's run in ``RL_MB2`` microbatches of a rank's rows (the
   gradient rounded where the cut rounds it) within ``RL_MB2_LOSS_REL``
   and ``RL_MB2_NORM_REL``, each rank's state bytes equal to its blocks',
   its launches exact, the
   all-gathers' and the gradient sums' count and result bytes equal to
   ``rank_local.forward_gathers``' and ``backward_sums``' arithmetic; it
   prints each rank's state bytes and peak memory and the wall (gloo's
   host staging); 25k the same three steps tensor-parallel under the
   default rules (``distributed.tensor_parallel``: each rank its 16 of
   32 query heads, half the MLP columns and vocabulary, its 2 rows),
   the losses of steps 1-2 and every norm against 25h's within
   ``TP_LOSS_REL`` and ``TP_NORM_REL`` (step 3's loss printed), the "tp"
   collectives, all-gathers and gradient sums
   equal to their arithmetic, launches as 25h's; 25i qwen3-4b's serving
   at full width cut to 8 layers (float32, N(0, 0.02)) on each rank's
   ``model`` blocks under ``SERVE_RULES`` (the reference's --no-fsdp:
   no weight gathered) through the serve steps under ``axis_rules`` with
   the cache cut (None, "data", None, "model"), each rank its 2 of 4
   rows and 1,024 of the 2,048 slots: a 1,024-token prefill, 4 decode
   steps and the next logits against rank 0's one-rank run (tokens
   equal, logits within ``CUT_DECODE_ATOL``); 25l recurrentgemma-9b's
   the same at full width cut to its first pattern group (rec, rec,
   attn), the recurrence on each rank's half of the channels; 25j
   qwen2-moe-a2.7b's expert-parallel and qwen3-4b's ring train steps at
   full width and 2 layers (bfloat16 weights, 4 x 512 tokens, rows cut)
   on a rank's blocks: EP reads its 30 of the 60 experts and the ring
   its 16 of 32 query heads (traded for a sequence block by an
   all-to-all and back; every K/V block read from the rank's own copy,
   no permute), neither gathered over "model"; remat full bit-equal to
   remat none, the all-to-alls and permutes of the recompute counted, the "state" gathers and "tp" collectives equal to
   the helpers' arithmetic; and one step on the layout that gathers the
   experts or the heads whole: EP's bit-equal, the ring's loss and norm
   within ``RING_HEADS_LOSS_REL`` and ``RING_HEADS_NORM_REL``; 25n
   25k's first step under ``seq_parallel`` (Megatron's sequence
   parallelism: a rank's 1,024 of the 2,048 positions between the
   sublayers), its loss and norm against 25k's step 1 within
   ``TP_LOSS_REL`` / ``TP_NORM_REL``, its collectives equal to their
   arithmetic, its peak beside 25k's; 25m mamba2-370m at full width and
   depth on a rank's 16 of 32 heads (the gated norm summed over "model"
   by the ``rmsnorm_cut`` kernels), ``MAMBA_STEPS`` steps against phase
   23's within ``TP_LOSS_REL`` / ``TP_NORM_REL``, collectives equal to
   their arithmetic, the SSD and cut-norm kernels launched on every rank
   (held by count), then a float32 prefill and decode steps on the
   rank's heads (``MAMBA_DECODE``, the cache its heads' state) against
   rank 0's one-rank run; then
   25g a world of one rank on NCCL (in a process of its own): 25a's shape on
   a (1, 1) mesh and 25c's, against the plain results.  Each sub-phase
   prints its mesh, shapes, max error and tolerance, the largest peak
   memory of a rank and its wall time, which is gloo's on one shared
   card (collectives staged through the host), not the card's
   collective rate.  A rank that fails fails the script; a world that
   reports nothing for ``DIST_TIMEOUT`` seconds is killed and fails it;
26. the dry run (``repro_torch.launch.dryrun``: one rank's step traced
   under ``FakeTensorMode`` on torch's ``fake`` process group, nothing
   allocated) and its roofline (``repro_torch.launch.roofline``, the
   H100's constants), each cell in a subprocess of its own, all at
   once.  26a traces phase 18's own step (tinyllama-1.1b, 4 x 2,048, one
   microbatch) on a 1 x 1 mesh and holds it against what phase 18
   measured: the argument bytes equal phase 18's ``TrainState`` on the
   card leaf for leaf (params, ``m``, ``v``) plus its batch and the
   4-byte step counter, and the roofline's compute term is no more than
   the measured step; it prints the memory term, the dominant term, the
   traced peak against phase 18's, the useful-flop ratio and the step's
   compute share.  26b runs the CLI on tinyllama-1.1b train_4k (single,
   the (16, 16) mesh, one microbatch where the reference's cell takes 8:
   its report is tagged ``mb1``; a rank holds its blocks of params, ``m``
   and ``v`` and its 16 of the 256 rows, ``TRAIN_4K_HELD`` bytes, held;
   its flops ``tensor_parallel.train_flops`` of its rows and its 1/16 of
   the heads, MLP columns and vocabulary, its "tp" collectives
   ``step_collectives``; its gradient sums as ``rank_local.backward_sums``
   counts them), qwen2-moe-a2.7b decode_32k through its
   presets (``--optimized``; expert parallelism on a rank's experts: a
   decode step's "state" gathers held to ``rank_local.forward_gathers``),
   mamba2-370m train_4k (one microbatch, on a rank's 2 of 32 heads: its
   flops the arithmetic and at least ``MAMBA_TRAIN4K_CUT`` times fewer
   than its rows' with every weight whole; its trace is the longest, so
   it starts before phase 25, ``DRYRUN_EARLY``), tinyllama-1.1b
   train_4k ``--sp`` (its flops those of the cell without ``--sp``, its
   temp bytes below them, its collectives the arithmetic) and
   tinyllama-1.1b decode_32k on the (2, 16,
   16) multi-pod mesh (512 ranks), under ``build/dryrun_torch``, and the
   roofline CLI over their reports; every cell holds exactly a device's
   share under the shardings (held); each cell's status, trace seconds,
   both argument figures and roofline row are printed.  26c traces
   qwen2-moe-a2.7b's expert-parallel train_4k step at two layers and its
   forward on the (16, 16) mesh, on CUDA fake tensors and on CPU ones,
   and holds the backward's collectives: equal on both devices (the
   backward runs on the autograd engine's CUDA thread), and the body's
   three times the forward's (step, recompute, backward); then
   qwen3-4b's train_4k step with ring attention at 2 layers on CUDA
   fake tensors: its flops a rank ``tensor_parallel.train_flops``, its
   "state" gathers ``forward_gathers``, its "tp" collectives (the ring's
   exchanges of heads for sequence blocks) ``step_collectives``, and no
   all-gather at the boundary.
27. the port's examples and scripts as users run them: each of
   ``examples/{zns_checkpointing,failover_demo,quickstart,serve_batch,
   train_small}_torch.py`` and ``scripts/{zns_hillclimb,inspect_collectives,
   make_experiments_tables}_torch.py`` as ``python3 <file>`` in a process
   of its own on the card, all at once (``EXAMPLES27``): train_small at
   ``--full-100m`` (12 layers x 768, vocabulary 16,384, 100.7e6
   parameters, 300 steps of 8 x 128 tokens with a ZNS checkpoint at step
   150, a restore into a fresh state and the resume), inspect_collectives
   on tinyllama-1.1b train_4k at depth 2, make_experiments_tables over
   phase 26's ``build/dryrun_torch``, and the two ZNS files also with
   ``--device cpu``.  Each must exit with 0 within ``EXAMPLES27_TIMEOUT``
   and end on its expected line; each writes its kernels' launches at
   exit (``REPRO_TORCH_LAUNCH_LOG``, :func:`repro_torch.kernels
   .launch_counts`), held to ``LAUNCHES27`` (the CPU runs launch
   nothing); the ZNS files' printed numbers on the card equal the CPU's
   within ``ZNS27_REL``.  Meanwhile, in this process, quickstart's body
   runs on ``kernel_impl="auto"`` (the kernels) and on ``"xla"`` (the
   plain versions, no launch): its 20 losses within ``QS_LOSS_REL`` and
   its 8 greedy tokens equal; and the ZNS files' bodies on the card and
   on the CPU, every number unrounded within ``ZNS27_REL`` and the text
   equal.  The card runs' launches and the in-process kernel runs' are
   added to the kernels line.

Phase 1 prints each built kernel's registers and spills (``ptxas -v``),
and fails if ptxas serialised any kernel's ``wgmma`` (warning C7518 in a
build log) or if a bfloat16 attention backward kernel, an RMSNorm
backward kernel of the vector path or the dw sum, or a float32 SSD
backward state walk spills.
Phase 2 also holds the flash-attention and RMSNorm kernels against their
plain versions at qwen3-4b's shapes, in bfloat16 and float32 at the
reference kernel tests' tolerances (attention atol 2e-2 / 2e-4, RMSNorm
2e-2 / 1e-4), and times them beside one PyTorch library call computing the
same function (attention: TFLOP/s over the visible pairs and the ratio to
SDPA; RMSNorm: GB/s); the two backward kernels against their plain
versions (``BWD_TOL``; two runs bit-equal) at tinyllama-1.1b's training
shape (4 x 32/4 heads x 2,048, D 64) and qwen3-4b's (D 128) for
attention, and at (8,192, 2,048) and the qk-norm rows (262,144, 128) for
RMSNorm, timed beside SDPA's and ``F.rms_norm``'s backward through
autograd (the RMSNorm backward also by ``torch.profiler``'s device time of
its kernels, two a call (more fails the script), with its share of the
bound and its kernels' registers), and the attention forward with and
without ``lse``; and counts the ``HGMMA`` (``wgmma``) instructions in
each function of the built flash-attention library (``cuobjdump
-sass``): none in the forward, or
in any instance of the bfloat16 backward's dK/dV or dQ kernel, fails the
script; the RMSNorm of rows cut over ranks (``rmsnorm_cut`` and its
backward, Mamba2's gated norm on a rank's heads) at 8,192 rows of 1,024
and of 128 of 2,048 columns in both dtypes, the other ranks' sums given,
against its plain versions and the whole rows' norm; likewise flash
attention at recurrentgemma-9b's prefill
shape (head dim 256, window 2,048), at musicgen-large's (2 x 32/32
heads x 1,024, D 64) and internvl2-26b's (2 x 48/8 x 1,024, D 128),
the SSD chunk scan at mamba2-370m's prefill shape and at batch 1 (y and
the final state; bfloat16 y rtol 1e-2 / atol 2e-2, state atol 1e-3;
TFLOP/s and the multiple of the bound;
the ``HMMA`` (``mma.sync``) count of its library, none fails the script)
and the linear recurrence at recurrentgemma-9b's, in float32 and bfloat16
(rtol 1e-3 / atol 2e-3, the reference kernel test's; GB/s); and the
recurrent families' backward kernels against their plain backwards and
against autograd through the plain forwards (``BWD_TOL``, two runs
bit-equal), timed beside the plain backwards: the attention backward at
D 256 with the window (1 x 16/1 heads x 4,096, window 2,048; beside
SDPA's backward with the window's mask, whose backend is named; with its
query-head groups G and its device time by kernel), the
linear recurrence's at (1, 4,096, 4,096) in float32 and the SSD scan's
at mamba2-370m's training shape (4 x 2,048, 32 heads, P 64, N 128,
chunk 128), in float32 (the register-tiled float32-core kernels,
``ssd_bwd_f32_walk`` and ``ssd_bwd_f32_chunk``) and bfloat16 (the
tensor-core kernels), with its device time by kernel (the split),
TFLOP/s and multiple of the bound; the ``HMMA`` count of each bfloat16
backward function (``ssd_bwd_walk`` and ``ssd_bwd_mma_chunk`` at 16
paddings of P and N; none in any fails the script) and the registers and
spills of every backward function.  Phases
3-6 go through the public entry points on ``device="cuda"`` and are
compared with the port's host float64 ``fixpoint="loop"`` driver (or the
host numpy scan) at rtol 1e-12.  Phases 7, 9 and 10 first run the model's 2-layer smoke
config in float32 and require equal greedy tokens with the kernels and
with the plain versions.  Phase 7 then compares the bfloat16 model's last
logits with the kernels against those with the plain versions (atol
0.25), phase 9 the float32 model's (atol 1e-3); phases 7, 9 and 10 print
both differences, the bfloat16 model's distance from the float32 model,
and the float32 model's own sensitivity (its first norm's scale moved by
one float32 step).  Phase 10 also holds recurrentgemma-9b's first four
blocks (rec, rec, attention, rec) one by one: each block is given the
plain chain's input and run with the kernels and with the plain
versions: the recurrent blocks in bfloat16 at the bfloat16 block
tolerance of ``tests/test_torch_rglru.py`` (rtol 2e-2, atol 8e-2); the
attention block, whose random-init logits of about 3,000 put it beyond
that tolerance for any two implementations, in float32 against a
float64 block, within that tolerance plus the plain float32 block's own
largest error (its kernels-vs-plain differences are printed).  Phase 16
does not hold qwen2-moe-a2.7b's whole-model logits at phase 7's
tolerance: routing is discrete, a choice that differs at the first
layers (a few of 8,192 in bfloat16) reroutes later tokens layer after
layer, in float32 too, so the script fails only when the logits differ
beyond 0.25 (bfloat16) or 1e-3 (float32) with every routing choice
alike.  It holds the first four layers one by one from the plain chain's
input: the attention half as phase 10's attention block (in float32
against float64; the init's logits reach the hundreds); the FFN norm at
the bfloat16 block tolerance; the MoE block on the plain norm's
output against a float32 expert-by-expert computation (the same top-k,
drops and shared expert) at the block tolerance; and the MoE block
kernels vs plain on every token both runs route alike (the others are
counted).  Every kernel's
launch counter is set to 0 just before each of the runs of phases 3-24
and 27 and read just after, all of them through
``repro_torch.kernels.reset_launch_counts`` and ``launch_counts`` (phase 25's ranks, each its own, around each
distributed run of the model path, 25b's ring forward, 25d's EP forward
and 25e's GPipe step, and hold them to the counts those runs make; the
parent adds them up, and no rank-0 baseline or oracle counts; phase 27's
processes count from 0 and write their counts at exit); a kernel
of the path that was never launched fails the script, and phase 9 fails
unless all 48 SSD launches of the bfloat16 prefill took the tensor-core
instance (``ssd_chunk_scan.mma_launches``).  The line
before the last is a JSON object with every kernel's numbers; the last
line is ``{"ok": true, "device": {...}}``.  Exits non-zero without a
CUDA device or without the repository's ``src/`` beside this file.
"""
import atexit
import dataclasses
import gc
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

ATTN_TOL = {"bfloat16": dict(rtol=0.0, atol=2e-2),
            "float32": dict(rtol=0.0, atol=2e-4)}
RMS_TOL = {"bfloat16": dict(rtol=0.0, atol=2e-2),
           "float32": dict(rtol=0.0, atol=1e-4)}
#: Phase 7: last-position logits (values of order 1-5) of the bfloat16
#: model with the kernels against the plain versions.  Both compute
#: attention and norms in float32 and round to bfloat16, so they differ
#: by rounding flips of one bfloat16 step (2^-8 relative) carried
#: through 36 layers.
LOGITS_ATOL = 0.25
#: Phase 9: the float32 model's last logits with the kernels against the
#: plain versions, which differ in summation order only (qwen3-4b's
#: float32 model measured 5.5e-6 in phase 7).  The bfloat16 difference is
#: reported beside the bfloat16 model's own distance from float32.
F32_LOGITS_ATOL = 1e-3
#: Phase 2, SSD chunk scan: kernel and plain version compute in float32 and
#: differ in summation order (the reference kernel test's atol 1e-3 for y
#: and the state); bfloat16 y may differ by one rounding step (2^-7).
SSD_TOL = {"bfloat16": dict(rtol=1e-2, atol=2e-2),
           "float32": dict(rtol=0.0, atol=1e-3)}
#: Phase 2, linear recurrence: the reference kernel test's tolerance.
LR_TOL = dict(rtol=1e-3, atol=2e-3)
#: Phase 2, the backward kernels against their plain versions on the same
#: forward outputs: both compute in float32 and differ in summation order
#: (gradients sum over thousands of rows), and bfloat16 results by their
#: last rounding (2^-8 relative): rtol, and atol as a fraction of the
#: tensor's largest magnitude.
BWD_TOL = {"bfloat16": (2e-2, 2e-3), "float32": (1e-3, 1e-4)}
#: Phase 18: the kernels' float32 gradients against a float64 plain step:
#: within the plain float32 step's own error plus this fraction of each
#: leaf's largest magnitude (float32 errors are ~1e-6 of it; a wrong
#: gradient is off by O(1) of it).
GRAD_F64_FRAC = 1e-4
#: Phase 18: the bfloat16 first-step gradients, kernels against plain
#: versions, each leaf's relative (Frobenius) gap: the bound of
#: tests/test_torch_train_bf16.py (BF16_REL).  Both round activations to
#: bfloat16 at places that differ, and the attention backward kernel
#: also rounds P and dS to bfloat16 for its tensor-core products.
BF16_GRAD_REL = 0.1
#: Phases 10b, 18, 20-22: every weight matrix N(0, INIT_STD), the llama
#: family's initializer_range.  The reference's fan-in rule takes the heads
#: axis as the fan-in of a (D, H, Dh) projection: at full depth its
#: gradients reach ~1e16 (tinyllama, 22 layers) and its attention logits
#: thousands (recurrentgemma), so no two implementations agree there.
INIT_STD = 0.02
#: Phases 23-24's learning rates.  An AdamW step moves every row of the
#: output head by about lr, which shifts every logit by about lr |x|_1
#: (~0.8 d_model lr for normalised x): 2.5 at mamba2-370m's d_model 1,024
#: and phases 18 and 22's lr 3e-3, where its loss went 11.04, 11.03,
#: 9.69, 12.22 (gradient norm 6.9 -> 26); 3.3 at recurrentgemma-9b's
#: 4,096 and 1e-3, where it went 13.29, 13.28, 13.30, 20.78 (9.6 -> 31).
#: The rates below shift a logit by about 0.8 and 0.7 a step.
RECURRENT_LR = {"23": 1e-3, "24": 2e-4}
#: Phase 18's forward time of the attention kernel at qwen3-4b's prefill
#: shape without lse (PR 19's phase 2, bfloat16).
ATTN_FWD_PR19_MS = 0.1203

#: Kernels that must not spill (ptxas -v): the bfloat16 attention
#: backward's, the RMSNorm backward's and the float32 SSD backward's
#: state walks, whose designs hold their accumulators in registers.  (The
#: float32 SSD chunk kernel's instances that hold the other side's whole
#: chunk spill a few bytes at 255 registers and are still the faster
#: layout; PERF.md has the timings.)
NO_SPILL = ("bwd_dkdv_wgmma", "bwd_dq_wgmma", "rmsnorm_bwd_vec",
            "rmsnorm_dw_sum", "ssd_bwd_f32_walk")

F64 = dict(rtol=1e-12, atol=1e-9)
F32 = dict(rtol=2e-5, atol=1e-2)
#: Phase 10, recurrentgemma-9b's blocks one by one in bfloat16, kernels
#: against plain versions on the same input: the block tolerance of
#: tests/test_torch_rglru.py (a few bfloat16 steps, 2^-8 relative each).
BF16_BLOCK_TOL = dict(rtol=2e-2, atol=8e-2)
#: Phase 13, the experiment runner against results/experiments/obs*.json
#: (written by the event engine): the float64 solve agrees to 1e-12 and
#: the metrics derived from it are held at the exactness matrix's
#: jitter-free rtol; obs14's ``oracle_max_rel_diff`` is itself a relative
#: difference and is held absolutely at its own check's bound.
RUNNER_RTOL = 1e-9
RUNNER_ORACLE_ATOL = 1e-9
#: Phase 14, the host goldens (event-engine completions) against the
#: card's vectorized backend: the reference golden test's tolerance.
GOLDEN_TOL = dict(rtol=1e-9, atol=1e-6)
#: Phase 19: the compiled cluster program against the greedy event-engine
#: oracle, per-op latency in microseconds (benchmarks/cluster_bench.py's
#: TOL_US).
CLUSTER_TOL_US = 1e-6
#: Phase 15's issue-time window, as benchmarks/mega_fleet.py's windowed row.
WINDOW_EVENTS = 131_072
#: Phase 16: the layers of qwen2-moe-a2.7b held one by one.
MOE_LAYERS = 4
#: Phase 17: the store's modeled seconds on the card against the same
#: calls on the CPU (the same float64 max-plus scan).
STORE_RTOL = 1e-12


#: Phase 25: the longest a world of ranks may go without reporting (also
#: its collectives' timeout).
DIST_TIMEOUT = 300
#: Phase 25a: ring attention against the plain attention (float32).
RING_ATOL = 1e-4
#: Phase 25a/25e: gradients through the ring and the pipeline, against
#: autograd through the plain single-rank computation: both float32,
#: summed in other orders; held at this fraction of the gradient's
#: largest magnitude.
DIST_GRAD_REL = 1e-4
#: Phase 25e: the pipeline's forward against the sequential stack (the
#: reference test's 1e-5), of the outputs' largest magnitude (at least 1).
PIPE_REL = 1e-5
#: Phase 25c: flash-decode against dense masked attention; 25d: EP logits
#: against moe_ffn's (the reference tests' 1e-4 and 1e-3).
DECODE_ATOL = 1e-4
EP_ATOL = 1e-3
#: Phase 25d: EP's aux loss against moe_ffn's on each data rank's half of
#: the batch, averaged: the same float32 quantity, computed apart (a sum
#: of 60 expert terms over 1,024 tokens a rank; a token routed otherwise
#: would move it by about 1e-4 of itself).
EP_AUX_REL = 1e-5
#: Phase 25f: the int8 compressed psum against its oracle (the reference
#: test's 1e-4).  The bf16 one is held element by element at the
#: summation bound of its three bfloat16 additions, (n-1) u sum_i |q_i| / n
#: with u = 2^-8 (plus 1e-6): gloo rounds each partial sum to bfloat16.
EF_INT8_ATOL = 1e-4
#: Phase 25h: tinyllama-1.1b's rank-local training on (2, 2) against phase
#: 18's one-rank steps from the same seed, weights and batches, three steps.
#: Each rank computes its 2 of the batch's 4 rows, so a weight's bfloat16
#: gradient is rounded a rank's rows at a time and the halves summed in
#: float32, where phase 18 rounds the sum of all four rows once.  Step 1
#: runs at lr 0 and leaves the weights where they were, so steps 1 and 2
#: read phase 18's weights: their losses are held at ``RL_LOSS_REL`` (the
#: card read them bit-equal), every norm at ``RL_NORM_REL`` (read 5.2e-06,
#: 8.5e-06 and 1.8e-04).  Step 3 reads the weights step 2's update moved,
#: and AdamW's first updates are close to lr * sign(g): a weight whose
#: rows' gradients nearly cancel moves the other way where the two
#: roundings disagree on its sign; its loss read 2.2e-04 from phase 18's,
#: above the 1e-4 that was asked, and is printed, not held against phase
#: 18.  Every step is held instead against phase 18's step with its 4
#: rows in two microbatches of a rank's 2 (``RL_MB2``), which rounds the
#: gradient where the cut does: its gradient blocks are bit-equal at steps
#: 1-2 (``scripts/rows_cut_probe.py``), its losses too; step 1's norm,
#: summed block by block, is an ulp away (7.6e-08), so are the clip scale,
#: m and v, and the weights step 2 moves round to bfloat16 otherwise where
#: they sit on a boundary: step 3's loss read 4.1e-05 and its norm 1.9e-05
#: away, held at ``RL_MB2_LOSS_REL`` and ``RL_MB2_NORM_REL`` (NVIDIA H100
#: 80GB HBM3, 700 W; PERF.md, PR 32)
RL_STEPS = 3
RL_LOSS_REL = 1e-6
RL_NORM_REL = 5e-4
RL_MB2 = 2
RL_MB2_LOSS_REL = 1e-4
RL_MB2_NORM_REL = 1e-4
#: 25h's batch (phase 18's): global batch, sequence length
RL_BATCH = (4, 2048)
#: 25h's rules: FSDP over both axes and nothing on "model" (the
#: reference's make_rules with its model axis one the mesh lacks), so
#: every weight is gathered whole and a rank's rows are computed as phase
#: 18 computes them
RL_RULES = dict(data_axes=("data",), fsdp_axes=("data", "model"),
                model_axis="tp")
#: Phase 25k: tinyllama-1.1b's tensor-parallel training on (2, 2) under
#: the default rules (heads, MLP columns and vocabulary on "model", rows
#: on "data"), three steps on 25h's weights and batches, each step's loss
#: and gradient norm against 25h's.  The one difference is the row
#: products: each rank's bfloat16 partial sum (wo, w_down) is rounded
#: before the all-reduce adds the two (gloo adds bfloat16 in bfloat16),
#: where 25h rounds the whole product once, and the column products'
#: input gradients likewise.  On the card (NVIDIA H100 80GB HBM3, 700 W)
#: the losses read 4.2e-05, 2.1e-06 and 2.98e-04 from 25h's and the norms
#: 2.2e-04, 1.3e-04 and 5.9e-05.  Step 3 reads weights that step 2's
#: updates moved, and as in 25h against phase 18 (2.179e-04) an update
#: near lr * sign(g) takes the other sign where the two roundings of a
#: nearly cancelling gradient disagree.  So the losses of steps 1-2,
#: which read the same weights, are held at TP_LOSS_REL, every norm at
#: TP_NORM_REL, and step 3's loss is printed.
TP_LOSS_REL = 2e-4
TP_NORM_REL = 5e-3
#: Phase 25m: mamba2-370m at full width and depth on a rank's heads,
#: (2, 2), phase 23's seed, weights, batches and learning rate: its first
#: ``MAMBA_STEPS`` steps held against phase 23's at ``TP_LOSS_REL`` /
#: ``TP_NORM_REL``; then a prefill and decode steps on its heads' blocks
#: under the --no-fsdp rules, (batch, prompt, max_seq, decode steps),
#: against rank 0's one-rank run at ``CUT_DECODE_ATOL``
MAMBA_STEPS = 2
MAMBA_DECODE = (2, 512, 1024, 2)
#: Phase 2's rows cut over ranks: mamba2-370m's gated norm at its training
#: shape (4 x 2,048 rows of d_inner 2,048), a rank's 1,024 or 128 columns
CUT_NORM_ROWS = 8192
CUT_NORM_WIDTH = 2048
#: Phases 25i and 25l: the reference's --no-fsdp rules (a rank holds only
#: its "model" blocks and gathers nothing a token)
SERVE_RULES = dict(fsdp=False, data_axes=("data",))
#: Phase 25l: recurrentgemma-9b at full width cut to its first pattern
#: group (rec, rec, attn): (batch, prompt, max_seq, decode steps)
RG_CUT_LAYERS = 3
RG_DECODE = (2, 1024, 2048, 4)
#: Phase 25i: qwen3-4b's decode at full width cut to 8 of its 36 layers
#: (every rank a replica of the weights, as the reference test's
#: ``in_shardings=None``: ~4.8 GB of float32 a rank), N(0, 0.02), the
#: cache cut (None, "data", None, "model") on (2, 2): (batch, prompt,
#: max_seq, decode steps); the logits against the one-rank replicated
#: decode at the reference test's 2e-3
CUT_DECODE_LAYERS = 8
CUT_DECODE = (4, 1024, 2048, 4)
CUT_DECODE_ATOL = 2e-3
#: Phase 25j: qwen2-moe-a2.7b's expert-parallel and qwen3-4b's ring train
#: steps at full width and 2 layers, rows cut on (2, 2), remat full held
#: bit-equal to remat none; bfloat16 weights (gloo stages every gather
#: through the host, its wall by the byte); the batch (4 x 1,024 until
#: 25k and 25l were added: halved to keep the script's wall)
REMAT_LAYERS = 2
REMAT_BATCH = (4, 512)
#: Phase 25j: the logical axis each case computes on blocks, which its
#: comparison step gathers whole over "model" instead (EP then cuts the
#: global experts in its shard_map, the ring runs on every head)
J_WHOLE = {"ep": "experts", "ring": "heads"}
#: Phase 25j: the ring on a rank's query heads against the ring on every
#: head (remat none, the same init and rows): the products are the same
#: but wo's row product, which sums each rank's bfloat16 partial in
#: bfloat16 (gloo), and the q, k and v input gradients' partial sums.
#: The card read 6.966e-06 (loss) and 8.574e-06 (norm) on an H100 80GB
#: HBM3 at 700 W (PERF.md); these leave some 7x and 12x above them
RING_HEADS_LOSS_REL = 5e-5
RING_HEADS_NORM_REL = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def close(got, want, tol, what: str) -> float:
    """Assert ``got`` ~ ``want`` (numpy arrays); returns max abs error."""
    import numpy as np
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    check(got.shape == want.shape, f"{what}: shape {got.shape} vs "
                                   f"{want.shape}")
    check(bool(np.isfinite(got).all()), f"{what}: non-finite values")
    err = np.abs(got - want)
    bad = err > tol["atol"] + tol["rtol"] * np.abs(want)
    check(not bad.any(), f"{what}: {int(bad.sum())} values outside "
                         f"{tol}; max abs err {float(err.max()):.3e}")
    return float(err.max()) if err.size else 0.0


def time_ms(fn, reps: int = 5, flush=None) -> float:
    """Median device time of ``fn()`` in ms (CUDA events, after one
    warm-up; ``flush`` is zeroed before each rep to evict the L2)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def device_ms(fn, key: str, reps: int = 5):
    """``(median device ms of the CUDA kernels whose name holds key in
    one call of fn, device kernels a call)`` from ``torch.profiler``
    (copies and memsets are not kernels; the L2 is not flushed), after
    one warm-up call, each call in its own profiled window.  The profiler
    on the H100 machine drops the first kernel of most windows, so each
    window first runs four short sleep kernels (``spin_kernel``),
    synchronising after each, and counts every kernel after the last
    sleep kernel it recorded: all that fn launched.  It still drops a
    kernel now and then, so the time is the median over the windows that
    saw the most kernels, and the kernels a call are that most; the time
    is None when the profiler records no device time.  A round of reps
    windows in which the profiler recorded kernels but no sleep kernel
    (it does so now and then on the H100, in runs of several rounds) is
    run again, up to six rounds; fails when no window of the last round
    recorded a sleep kernel (the count would hold them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        seen, slept = [], 0
        for _ in range(reps):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    torch.cuda._sleep(1000)
                    torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
            ev = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and not e.name.startswith(("Memcpy", "Memset"))),
                        key=lambda e: e.time_range.start)
            sleeps = [i for i, e in enumerate(ev)
                      if "spin_kernel" in e.name]
            ev = ev[sleeps[-1] + 1:] if sleeps else ev
            slept += bool(sleeps)
            t = sum(e.time_range.elapsed_us() for e in ev if key in e.name)
            seen.append((len(ev), t / 1e3))
        if slept > 0 or not any(n for n, _ in seen):
            break
    check(slept > 0 or not any(n for n, _ in seen),
          f"device_ms ({key}): the profiler recorded no sleep kernel")
    most = max(n for n, _ in seen)
    times = sorted(t for n, t in seen if n == most and t)
    return (times[len(times) // 2] if times else None), most


def kernel_group(name: str) -> str:
    """A CUDA kernel's name as the part of the model it serves."""
    for key, group in (("fp_solve_kernel", "zns_fixpoint"),
                       ("fp_stack_kernel", "zns_fixpoint_sharded"),
                       ("fp_cluster_kernel", "zns_fixpoint_sharded"),
                       ("scan_tiles_kernel", "zns_event_scan"),
                       ("flash_fwd", "flash_attention"),
                       ("bwd_dkdv", "flash_attention_bwd"),
                       ("bwd_dq", "flash_attention_bwd"),
                       ("bwd_delta", "flash_attention_bwd"),
                       ("bwd_fused", "flash_attention_bwd"),
                       ("rmsnorm_bwd", "rmsnorm_bwd"),
                       ("rmsnorm_dw", "rmsnorm_bwd"),
                       ("rmsnorm", "rmsnorm"),
                       ("ssd_bwd", "ssd_chunk_scan_bwd"),
                       ("ssd_chunk_scan", "ssd_chunk_scan"),
                       ("ssd_mma", "ssd_chunk_scan"),
                       ("linear_recurrence_bwd", "linear_recurrence_bwd"),
                       ("linear_recurrence", "linear_recurrence"),
                       ("nvjet", "matmul"),
                       ("gemm", "matmul"), ("gemv", "matmul"),
                       ("xmma", "matmul"), ("cutlass", "matmul"),
                       ("copy_kernel", "copy/cast"), ("Memcpy", "copy/cast"),
                       ("softmax", "softmax"), ("reduce", "reduce"),
                       # sorts, bincount, cumsum, index, gather, scatter:
                       # the MoE dispatch, embedding lookups, cache writes
                       ("Sort", "sort/index/scatter"),
                       ("sort", "sort/index/scatter"),
                       ("Histogram", "sort/index/scatter"),
                       ("DeviceScan", "sort/index/scatter"),
                       ("index", "sort/index/scatter"),
                       ("gather", "sort/index/scatter"),
                       ("scatter", "sort/index/scatter")):
        if key in name:
            return group
    return "other elementwise"


def device_breakdown(fn):
    """Run ``fn()`` once under ``torch.profiler``; returns (wall ms, kernel
    ms, device events, [(group, ms), ...] largest first, {group: device
    events}) from the CUDA kernel events, or None when the profiler
    records no device time.  The wall time includes the profiler's own
    overhead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    groups, counts = {}, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            g = kernel_group(e.name)
            groups[g] = groups.get(g, 0.0) + e.time_range.elapsed_us() / 1e3
            counts[g] = counts.get(g, 0) + 1
    if not groups:
        return None
    return (wall, sum(groups.values()), sum(counts.values()),
            sorted(groups.items(), key=lambda kv: -kv[1]), counts)


def kernel_split(fn, key: str, tries: int = 3):
    """{kernel: device ms} of the kernels whose name holds key in one
    profiled call of fn (after a warm-up call), or None when the profiler
    records none of them.  Each window runs four sleep kernels first (the
    profiler on the H100 machine drops a window's first kernels, as
    ``device_ms`` notes); of ``tries`` windows, the one that saw the most
    of fn's kernels is read."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA and key in e.name:
                # "void (anonymous namespace)::name<args>(params)" -> name<args>
                name = re.sub(r"^void |\(anonymous namespace\)::", "",
                              e.name).split("(")[0]
                out[name] = round(out.get(name, 0.0)
                                  + e.time_range.elapsed_us() / 1e3, 4)
        if len(out) > len(best):
            best = out
    return best or None


def kernel_name(mangled: str) -> str:
    """``name<args>`` from an Itanium-mangled kernel name (nested-name
    components, then integer, ``bf16`` and ``f32`` template arguments)."""
    i = mangled.find("_ZN")
    if i < 0:
        return mangled
    i, name = i + 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        n = re.match(r"\d+", mangled[i:]).group()
        i += len(n)
        name, i = mangled[i:i + int(n)], i + int(n)
    if mangled[i:i + 1] != "I":
        return name
    args = []
    for lit, bf, f in re.findall(r"Li(-?\d+)E|(13__nv_bfloat16)|(f)",
                                 mangled[i + 1:].split("EE", 1)[0] + "E"):
        args.append(lit or ("bf16" if bf else "f32"))
    return f"{name}<{', '.join(args)}>"


def ptxas_lines(log: str):
    """``(kernel, registers, spill line)`` for every kernel of an ``nvcc
    -Xptxas -v`` log."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            name = kernel_name(line.rsplit(" ", 1)[-1])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((name, int(regs.group(1)) if regs else -1, spill))
            name = None
    return out


def bound_ms(nbytes: float, ops: float, dtype: str):
    """The least ms for ``nbytes`` at the card's memory rate and ``ops`` at
    its peak rate for ``dtype`` (``repro_torch.launch.roofline``'s H100
    constants)."""
    from repro_torch.launch import roofline
    t_bytes = nbytes / roofline.HBM_BW * 1e3
    t_ops = ops / roofline.PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dist_need(cond: bool, msg: str) -> None:
    """A rank's check: raises, so that the world fails the phase."""
    if not cond:
        raise RuntimeError(msg)


def _dist_tools(rank: int, report):
    """(say, run, peak_gb) for a phase-25 rank: ``say(line)`` prints from
    rank 0 (every rank reports, which keeps the world's timeout fresh);
    ``run(fn)`` gives ``(fn(), wall s)`` between two barriers on
    synchronised ranks, the peak memory counted from its start;
    ``peak_gb()`` the largest peak of any rank since."""
    import torch
    import torch.distributed as dist

    def say(line):
        report(line if rank == 0 else None)

    def run(fn):
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        dist.barrier()
        return out, time.perf_counter() - t

    def peak_gb():
        x = torch.tensor([torch.cuda.max_memory_allocated() / 1e9],
                         device=DIST_DEVICE)
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
        return float(x)

    return say, run, peak_gb


def _max_err(a, b) -> float:
    """The largest |a - b|, in float32 (the tensors may be GBs)."""
    return float((a.float() - b.float()).abs().max())


def _dense_decode(q, ck, cv, pos: int):
    """Dense masked decode attention, the reference test's oracle."""
    import torch
    logits = torch.einsum("bkrd,bksd->bkrs", q, ck) / (q.shape[-1] ** 0.5)
    valid = torch.arange(ck.shape[2], device=q.device) <= pos
    logits = torch.where(valid[None, None, None], logits, -1e30)
    return torch.einsum("bkrs,bksd->bkrd", torch.softmax(logits, -1), cv)


#: Phase 25's device (each rank's), and shapes: qwen3-4b's attention (B,
#: Hq, Hkv, S, D) and decode cache (B, K, rep, S, D, pos).
DIST_DEVICE = "cuda"
RING_SHAPE = (2, 32, 8, 4096, 128)
DECODE_SHAPE = (4, 8, 4, 32768, 128, 30000)


def _ring_inputs(dtype=None):
    import torch
    b, hq, hkv, s, d = RING_SHAPE
    g = torch.Generator(DIST_DEVICE).manual_seed(0)
    return [torch.randn(shape, generator=g, device=DIST_DEVICE, dtype=dtype)
            for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def _decode_inputs():
    import torch
    b, k, rep, s, d, _ = DECODE_SHAPE
    g = torch.Generator(DIST_DEVICE).manual_seed(1)
    return [torch.randn(shape, generator=g, device=DIST_DEVICE)
            for shape in ((b, k, rep, d), (b, k, s, d), (b, k, s, d))]


def phase25_rank(rank, report, p18, p23):
    """One of phase 25's four gloo ranks on the shared card (25a-25f, 25h
    against phase 18's numbers ``p18``, 25k and 25n against 25h's, 25i,
    25l, 25m against phase 23's numbers ``p23``, and 25j); returns its
    kernel launches and rank 0 its numbers."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed.collectives import (
        compressed_psum_reference, ef_compressed_psum, init_error_state)
    from repro_torch.distributed.flash_decode import flash_decode
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.pipeline import (
        gpipe, stack_stage_fn, stages_from_stack)
    from repro_torch.distributed.ring_attention import ring_attention
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ref as kref
    from repro_torch.models import common as cm
    from repro_torch.utils.tree import tree_flatten, tree_unflatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    cuda = torch.device(DIST_DEVICE)
    say, run, peak_gb = _dist_tools(rank, report)
    gloo = "wall (gloo, 4 ranks on one card, not the card's collective rate)"
    meshes = {shape: Mesh(shape, ("data", "model"), backend="gloo",
                          device=cuda) for shape in ((1, 4), (2, 2))}
    pipe = Mesh((4,), ("pipe",), backend="gloo", device=cuda)
    pod = Mesh((4,), ("pod",), backend="gloo", device=cuda)
    rules = sh.make_rules(data_axes=("data",))
    counted = ("flash_attention", "flash_attention_bwd", "rmsnorm",
               "rmsnorm_bwd", "linear_recurrence", "ssd_chunk_scan",
               "ssd_chunk_scan_bwd", "rmsnorm_cut", "rmsnorm_cut_bwd")
    launched = {}

    def run_counted(sub, fn, want):
        """``run(fn)`` of a distributed run of the main path, its kernel
        launches counted from 0 and held against ``want`` (this rank's
        launches, by kernel); the rank-0 baselines and oracles run
        outside it and count nowhere."""
        K.reset_launch_counts()
        out = run(fn)
        launched[sub] = got = {k: K.launch_counts()[k] for k in counted}
        _dist_need(got == {k: want.get(k, 0) for k in counted},
                   f"{sub}: kernel launches {got} on rank {rank}, want "
                   f"{want}")
        return out

    def norms(cfg):
        """RMSNorm launches of one decoder layer (ln1, ln2, and the q/k
        norms where the config has them)."""
        return 2 + 2 * bool(cfg.qk_norm)

    rows = {}
    # warm up cuBLAS and the gloo pairs, so that 25a's first wall is not
    # their start-up
    w = torch.ones(256, 256, device=cuda)
    dist.all_reduce(w @ w)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # -- 25a: ring attention at qwen3-4b's attention shape -----------------
    q, k, v = _ring_inputs()
    want = kref.attention_ref(q, k, v, causal=True) if rank == 0 else None
    for shape, mesh in meshes.items():
        out, wall = run(lambda: ring_attention(mesh, q, k, v, causal=True))
        err = _max_err(out, want) if rank == 0 else 0.0
        _dist_need(err <= RING_ATOL, f"25a ring attention on mesh {shape}: "
                                     f"max abs err {err:.3e} > {RING_ATOL}")
        say(f"[25a] ring attention, mesh {shape} (data, model), q "
            f"{tuple(q.shape)} k/v {tuple(k.shape)} float32 causal: max abs "
            f"err {err:.3e} vs the plain attention (tol {RING_ATOL}); peak "
            f"{peak_gb():.2f} GB a rank; {gloo} {wall * 1e3:.1f} ms")
        rows[f"25a {shape}"] = dict(err=err, wall_s=wall, peak_gb=peak_gb())
        del out
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    out, wall = run(lambda: ring_attention(meshes[(2, 2)], qb, kb, vb))
    err = _max_err(out, want) if rank == 0 else 0.0
    _dist_need(err <= ATTN_TOL["bfloat16"]["atol"],
               f"25a bfloat16 ring: max abs err {err:.3e}")
    say(f"[25a] ring attention in bfloat16, mesh (2, 2): max abs err "
        f"{err:.3e} vs the float32 plain attention (the bf16 kernel "
        f"tolerance {ATTN_TOL['bfloat16']['atol']}); peak {peak_gb():.2f} "
        f"GB a rank; {gloo} {wall * 1e3:.1f} ms")
    rows["25a bf16"] = dict(err=err, wall_s=wall)
    del out, qb, kb, vb, want
    free()
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))

    def ring_grad():
        out = ring_attention(meshes[(2, 2)], qg, kg, vg, causal=True)
        (out ** 2).sum().backward()

    _, wall = run(ring_grad)
    peak = peak_gb()
    errs = []
    if rank == 0:
        qd, kd, vd = (t.clone().requires_grad_(True) for t in (q, k, v))
        (kref.attention_ref(qd, kd, vd, causal=True) ** 2).sum().backward()
        for name, got, ref_ in (("dq", qg, qd), ("dk", kg, kd),
                                ("dv", vg, vd)):
            scale = float(ref_.grad.abs().max())
            e = _max_err(got.grad, ref_.grad)
            errs.append(f"{name} {e:.3e} of {scale:.3e}")
            _dist_need(e <= DIST_GRAD_REL * scale,
                       f"25a ring gradient {name}: max abs err {e:.3e} > "
                       f"{DIST_GRAD_REL} x {scale:.3e}")
        del qd, kd, vd
    say(f"[25a] gradient of sum(out^2) through the ring, mesh (2, 2): "
        f"{'; '.join(errs)} (max abs err of max |grad|, tol "
        f"{DIST_GRAD_REL} of it) vs autograd of the plain attention; peak "
        f"{peak:.2f} GB a rank; {gloo} {wall * 1e3:.1f} ms")
    rows["25a grad"] = dict(errs=errs, wall_s=wall, peak_gb=peak)
    del q, k, v, qg, kg, vg
    free()

    # -- 25b: qwen3-4b forward with ring_attention=True ----------------------
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=4,
                              dtype="float32")
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                           device=cuda, weight_std=INIT_STD)
    toks = torch.randint(0, cfg.vocab_size, (2, 2048),
                         generator=torch.Generator().manual_seed(0)).to(cuda)
    ring_cfg = dataclasses.replace(cfg, ring_attention=True)
    with torch.no_grad():
        # the forward without a context runs on rank 0 alone (it holds
        # no collective); the one with the ring on every rank
        fa0 = kfa.flash_attention.launches
        plain, wall_p = run(lambda: M.forward(cfg, params, toks)[0]
                            if rank == 0 else None)
        fa1 = kfa.flash_attention.launches
        with dctx.axis_rules(meshes[(2, 2)], rules):
            # the ring takes the flash-attention kernel's place
            ringed, wall = run_counted(
                "25b", lambda: M.forward(ring_cfg, params, toks)[0],
                {"rmsnorm": norms(cfg) * cfg.num_layers + 1})
    _dist_need(fa1 - fa0 == (cfg.num_layers if rank == 0 else 0),
               f"25b: flash-attention launches {fa1 - fa0} without the "
               f"context")
    err, scale = 0.0, 0.0
    if rank == 0:
        err = _max_err(ringed, plain)
        scale = float(plain.abs().max())
    _dist_need(bool(torch.isfinite(ringed).all()) and err <= F32_LOGITS_ATOL,
               f"25b: logits max abs err {err:.3e} > {F32_LOGITS_ATOL}")
    say(f"[25b] qwen3-4b at full width, 4 of 36 layers, float32, tokens "
        f"{tuple(toks.shape)}: logits {tuple(ringed.shape)} with ring "
        f"attention under axis_rules on (2, 2) vs the flash-attention "
        f"kernel without a context: max abs err {err:.3e} (max |logit| "
        f"{scale:.3f}; tol {F32_LOGITS_ATOL}); flash-attention launches "
        f"{fa1 - fa0} without the context / "
        f"{launched['25b']['flash_attention']} under it; peak "
        f"{peak_gb():.2f} GB a rank; "
        f"{gloo} {wall:.2f} s (no context, rank 0 alone, {wall_p:.2f} s)")
    rows["25b"] = dict(err=err, max_logit=scale, wall_s=wall,
                       plain_wall_s=wall_p, peak_gb=peak_gb())
    del params, plain, ringed
    free()

    # -- 25c: flash-decode at qwen3-4b's decode cache ---------------------------
    q, ck, cv = _decode_inputs()
    pos = DECODE_SHAPE[-1]
    out, wall = run(lambda: flash_decode(meshes[(1, 4)], q, ck, cv, pos))
    err = _max_err(out, _dense_decode(q, ck, cv, pos)) if rank == 0 else 0.0
    _dist_need(err <= DECODE_ATOL, f"25c flash-decode: max abs err "
                                   f"{err:.3e} > {DECODE_ATOL}")
    say(f"[25c] flash-decode, mesh (1, 4), q {tuple(q.shape)} cache "
        f"{tuple(ck.shape)} pos {pos}: max abs err {err:.3e} vs dense "
        f"masked attention (tol {DECODE_ATOL}); peak {peak_gb():.2f} GB a "
        f"rank; {gloo} {wall * 1e3:.1f} ms")
    rows["25c"] = dict(err=err, wall_s=wall, peak_gb=peak_gb())
    del q, ck, cv, out
    free()

    # -- 25d: expert-parallel MoE at qwen2-moe-a2.7b's full width -----------
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"), num_layers=2,
                              dtype="float32", moe_capacity_factor=8.0,
                              moe_expert_pad=0)
    ep = dataclasses.replace(cfg, moe_impl="ep")
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                           device=cuda, weight_std=INIT_STD)
    toks = torch.randint(0, cfg.vocab_size, (4, 512),
                         generator=torch.Generator().manual_seed(0)).to(cuda)
    def dropped():
        return sum(int((~r.valid).sum()) for layer in params.layers
                   for r in layer.routing)

    for layer in params.layers:
        layer.routing = []
    with torch.no_grad():
        # moe_ffn on rank 0 alone (no collective); EP on every rank
        (l_gs, aux_gs), wall_gs = run(lambda: M.forward(cfg, params, toks)
                                      if rank == 0 else (None, 0.0))
        drop_gs = dropped()
        # EP's aux is the mean over the data ranks of each one's aux on
        # its half of the batch: the same on moe_ffn, half by half
        aux_halves = (sum(float(M.forward(cfg, params, half)[1])
                          for half in toks.chunk(2)) / 2
                      if rank == 0 else 0.0)
        for layer in params.layers:
            layer.routing = []
        with dctx.axis_rules(meshes[(2, 2)], rules):
            (l_ep, aux_ep), wall = run_counted(
                "25d", lambda: M.forward(ep, params, toks),
                {"flash_attention": cfg.num_layers,
                 "rmsnorm": norms(cfg) * cfg.num_layers + 1})
    n = torch.tensor([dropped()])
    dist.all_reduce(n)
    drop_ep = int(n)
    err = _max_err(l_ep, l_gs) if rank == 0 else 0.0
    aux_err = abs(float(aux_ep) - aux_halves) if rank == 0 else 0.0
    _dist_need(err <= EP_ATOL and drop_gs == 0 and drop_ep == 0,
               f"25d: logits max abs err {err:.3e} (tol {EP_ATOL}), dropped "
               f"{drop_gs} / {drop_ep}")
    _dist_need(aux_err <= EP_AUX_REL * abs(aux_halves),
               f"25d: EP aux {float(aux_ep):.7f} vs moe_ffn's mean over the "
               f"two halves {aux_halves:.7f} (tol {EP_AUX_REL} relative)")
    say(f"[25d] qwen2-moe-a2.7b at full width ({cfg.moe_num_experts} "
        f"experts top-{cfg.moe_top_k}, d_ff {cfg.moe_d_ff}), 2 of 24 layers, "
        f"float32, tokens {tuple(toks.shape)}, "
        f"capacity factor 8: EP on (2, 2) vs moe_ffn: logits max abs err "
        f"{err:.3e} (tol {EP_ATOL}); dropped {drop_ep} (EP, all ranks) / "
        f"{drop_gs}; aux {float(aux_ep):.7f} (EP, the mean of the data "
        f"ranks') vs {aux_halves:.7f} (moe_ffn on each data rank's half, "
        f"averaged): err {aux_err:.3e} (tol {EP_AUX_REL} relative), "
        f"{float(aux_gs):.6f} on the whole batch; peak {peak_gb():.2f} GB "
        f"a rank; "
        f"{gloo} {wall:.2f} s (moe_ffn {wall_gs:.2f} s)")
    rows["25d"] = dict(err=err, dropped=drop_ep, aux_ep=float(aux_ep),
                       aux_halves=aux_halves, aux_err=aux_err,
                       aux=float(aux_gs), wall_s=wall, peak_gb=peak_gb())
    # the loop's last layer views the stacked weights of both layers
    del params, layer, l_gs, l_ep
    free()

    # -- 25e: GPipe over 4 stages of qwen3-4b's decoder block -----------------
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=8,
                              dtype="float32")
    layers = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                           device=cuda, weight_std=INIT_STD
                           ).param_tree()["layers"]
    free()
    positions = torch.arange(1024, dtype=torch.int32, device=cuda)[None]

    def layer_fn(lp, h):
        h = h + cm.attention(cfg, lp["attn"], cm.rmsnorm(cfg, lp["ln1"], h),
                             positions)
        return h + cm.mlp(lp["mlp"], cm.rmsnorm(cfg, lp["ln2"], h))

    leaves, treedef = tree_flatten(stages_from_stack(layers, 4))
    leaves = [a.detach().requires_grad_(True) for a in leaves]
    stages = tree_unflatten(treedef, leaves)
    x = torch.randn((4, 1, 1024, cfg.d_model),
                    generator=torch.Generator(cuda).manual_seed(2),
                    device=cuda)

    def pipe_run():
        y = gpipe(pipe, stack_stage_fn(layer_fn), stages, x)
        (y ** 2).sum().backward()
        return y.detach()

    # every rank runs its stage at each of the M + n - 1 ticks, bubbles
    # included, and its backward
    per_tick = {"flash_attention": 2, "flash_attention_bwd": 2,
                "rmsnorm": 2 * norms(cfg), "rmsnorm_bwd": 2 * norms(cfg)}
    ticks = x.shape[0] + pipe.shape["pipe"] - 1
    y, wall = run_counted("25e", pipe_run,
                          {k: ticks * v for k, v in per_tick.items()})
    peak = peak_gb()
    errs = []
    if rank == 0:
        flat, ltd = tree_flatten(layers)
        seq_leaves = [a.detach().clone().requires_grad_(True) for a in flat]
        outs = []
        for mb in x:
            h = mb
            for i in range(cfg.num_layers):
                h = layer_fn(tree_unflatten(ltd, [a[i] for a in seq_leaves]),
                             h)
            outs.append(h)
        want = torch.stack(outs)
        (want ** 2).sum().backward()
        want = want.detach()
        scale = max(float(want.abs().max()), 1.0)
        e = _max_err(y, want)
        errs.append(f"forward {e:.3e} of {scale:.3e}")
        _dist_need(e <= PIPE_REL * scale, f"25e forward: max abs err "
                                          f"{e:.3e} > {PIPE_REL} x {scale}")
        worst = (0.0, "")
        for (path, got), ref_ in zip(_leaf_paths(stages), seq_leaves):
            g_want = ref_.grad.reshape(got.grad.shape)
            gs = float(g_want.abs().max())
            e = _max_err(got.grad, g_want)
            _dist_need(e <= DIST_GRAD_REL * gs,
                       f"25e gradient {path}: max abs err {e:.3e} > "
                       f"{DIST_GRAD_REL} x {gs:.3e}")
            worst = max(worst, (e / max(gs, 1e-30), path))
        errs.append(f"gradients: largest err / max |grad| {worst[0]:.3e} "
                    f"({worst[1]})")
        # h's graph holds the sequential stack's leaves and their grads
        del flat, seq_leaves, outs, want, h, mb, got, ref_, g_want
    say(f"[25e] GPipe, mesh (4,) (pipe), 4 stages x 2 qwen3-4b decoder "
        f"layers at full width, float32, M 4 microbatches of 1 x 1,024: "
        f"{'; '.join(errs)} vs the sequential stack's autograd (tol "
        f"{PIPE_REL} / {DIST_GRAD_REL} of the largest magnitude); peak "
        f"{peak:.2f} GB a rank; {gloo} {wall:.2f} s (forward, backward and "
        f"the gradients' gather)")
    rows["25e"] = dict(errs=errs, wall_s=wall, peak_gb=peak)
    del layers, leaves, stages, x, y
    free()

    # -- 25f: compressed collectives on tinyllama-1.1b's leaves ----------------
    spec = M.model_spec(get_config("tinyllama-1.1b"))
    shapes = {"embed": spec["embed"]["embedding"].shape}
    shapes.update({f"layer/{'/'.join(p)}": s.shape[1:] for p, s in
                   cm.spec_leaves(spec["layers"])})
    g = torch.Generator(cuda).manual_seed(3)
    grads = {name: torch.randn((4,) + tuple(s), generator=g, device=cuda)
             * torch.arange(1, 5, device=cuda).view((4,) + (1,) * len(s))
             for name, s in shapes.items()}
    n_el = sum(int(np.prod(s)) for s in shapes.values())
    for method in ("bf16", "int8"):
        (out, errs_), wall = run(lambda: ef_compressed_psum(
            pod, grads, init_error_state(grads), method=method))
        worst = 0.0
        if rank == 0:
            for name, gl in grads.items():
                want = compressed_psum_reference(list(gl), method)
                e = (out[name] - want).abs()
                if method == "bf16":
                    q_abs = sum(t.bfloat16().float().abs() for t in gl)
                    bound = 3 * 2.0 ** -8 * q_abs / 4 + 1e-6
                    _dist_need(bool((e <= bound).all()),
                               f"25f bf16 {name}: beyond the summation bound"
                               f" (max abs err {float(e.max()):.3e})")
                else:
                    _dist_need(float(e.max()) <= EF_INT8_ATOL,
                               f"25f int8 {name}: max abs err "
                               f"{float(e.max()):.3e} > {EF_INT8_ATOL}")
                worst = max(worst, float(e.max()))
                _dist_need(tuple(errs_[name].shape) == tuple(gl.shape),
                           f"25f {name}: error state {errs_[name].shape}")
        tol = ("the bf16 summation bound, element by element" if
               method == "bf16" else f"{EF_INT8_ATOL}")
        say(f"[25f] ef_compressed_psum {method}, mesh (4,) (pod), "
            f"tinyllama-1.1b's embedding {tuple(shapes['embed'])} and one "
            f"decoder layer's {len(shapes) - 1} leaves ({n_el:,} values a "
            f"pod): max "
            f"abs err {worst:.3e} vs compressed_psum_reference (tol {tol}); "
            f"peak {peak_gb():.2f} GB a rank; {gloo} {wall:.2f} s")
        rows[f"25f {method}"] = dict(err=worst, wall_s=wall,
                                     peak_gb=peak_gb())
        del out, errs_
    del grads
    free()
    d = shapes["layer/ln1"]
    steps = torch.randn((30, 4) + tuple(d), generator=g, device=cuda) * 0.01
    err = {"g": torch.zeros((4,) + tuple(d), device=cuda)}
    acc = torch.zeros(d, device=cuda)
    for st in steps:
        o, err = ef_compressed_psum(pod, {"g": st}, err, method="int8")
        acc = acc + o["g"]
    true = steps.double().mean(1).sum(0)
    rel = float((acc.double() - true).abs().max() / true.abs().max())
    _dist_need(rel < 0.2, f"25f int8 drift {rel:.3f} >= 0.2")
    say(f"[25f] 30 int8 steps at scale 0.01 on a {tuple(d)} leaf: the "
        f"accumulated update's drift {rel:.4f} relative (< 0.2)")
    rows["25f drift"] = dict(rel=rel)
    del steps, err, acc, true
    free()

    # -- 25h: tinyllama-1.1b training with rank-local state ------------------
    rows["25h"] = phase25h(rank, say, run_counted, meshes[(2, 2)],
                           sh.make_rules(**RL_RULES), p18)
    # -- 25k: the same steps tensor-parallel over model ----------------------
    rows["25k"] = phase25k(rank, say, run_counted, meshes[(2, 2)], rules,
                           rows["25h"])
    # -- 25n: 25k's step 1 under Megatron's sequence parallelism -----------
    rows["25n"] = phase25n(rank, say, run_counted, meshes[(2, 2)], rules,
                           rows["25k"])
    # -- 25i: qwen3-4b's decode on a rank's model blocks, the cache cut ------
    serve_rules = sh.make_rules(**SERVE_RULES)
    rows["25i"] = phase25i(rank, say, run, run_counted, peak_gb,
                           meshes[(2, 2)], serve_rules, norms)
    # -- 25l: recurrentgemma-9b's prefill and decode on its channels ---------
    rows["25l"] = phase25l(rank, say, run, run_counted, peak_gb,
                           meshes[(2, 2)], serve_rules)
    # -- 25m: mamba2-370m's training and serving on a rank's heads ---------
    rows["25m"] = phase25m(rank, say, run, run_counted, peak_gb,
                           meshes[(2, 2)], rules, serve_rules, p23)
    # -- 25j: the EP and ring train steps on their rows, remat ---------------
    rows["25j"] = phase25j(rank, say, run_counted, peak_gb, meshes[(2, 2)],
                           rules, norms)
    return dict(launches=launched, rows=rows if rank == 0 else None)


def serve_on_blocks(rank, run, run_counted, peak_gb, mesh, rules, cfg,
                    shape, sub, want) -> dict:
    """Serving on a rank's ``model`` blocks (phases 25i and 25l): the
    global weights drawn on every rank (seed 0, N(0, 0.02)), rank 0's
    one-rank run of the serve steps, then each rank's blocks under
    ``rules`` (``rank_local.serve_blocks``; the global weights freed) run
    through the same steps under ``axis_rules(mesh, rules)``: a prefill of
    ``shape`` = (batch, prompt, max_seq, decode steps), the decode steps,
    and the next logits (gathered over the vocabulary's blocks and the
    rows).  The tokens equal and the logits within ``CUT_DECODE_ATOL`` of
    the one-rank run's, the weights' gathers (``"state"``) those of
    ``rank_local.forward_gathers`` a forward (none but Mamba2's
    ``in_proj`` and conv, gathered over "model" on its heads), the
    ``"tp"`` collectives of the serve steps
    ``tensor_parallel.serve_collectives``, the launches ``want``."""
    import torch

    from repro_torch import models as M
    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed import rank_local
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.mesh import all_gather_dim
    from repro_torch.serve import make_prefill_step, make_serve_step
    from repro_torch.serve.step import serving_cut
    from repro_torch.utils.comm_stats import record_collectives

    cuda = torch.device(DIST_DEVICE)
    b, s, max_seq, n_dec = shape
    params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                           device=cuda, weight_std=INIT_STD)
    prompt = torch.randint(0, cfg.vocab_size, (b, s),
                           generator=torch.Generator().manual_seed(4)).to(cuda)
    layout = rank_local.layout_for(cfg, mesh, rules)
    tp = layout.model_cut()

    def serve(p, model_cut):
        with record_collectives() as rec:
            tok, cache = make_prefill_step(cfg, max_seq)(p, prompt)
            toks = [tok]
            step = make_serve_step(cfg, max_seq)
            for i in range(n_dec):
                tok, cache = step(p, cache, tok, s + i)
                toks.append(tok)
        c = serving_cut(cfg, b, max_seq)
        with dctx.row_cut(c), dctx.model_cut(model_cut):
            logits, _ = M.decode_step(cfg, p, cache,
                                      tok if c is None else c.take(tok),
                                      s + n_dec)
        if model_cut is not None:
            logits = all_gather_dim(mesh, logits, model_cut.axes,
                                    logits.dim() - 1, site="tp")
        if c is not None:
            logits = c.gather(logits)
        sites = {k: (sum(rec.stats(k).count.values()),
                     int(rec.stats(k).total_result_bytes))
                 for k in ("state", "tp")}
        return (torch.stack(toks, 1), logits,
                None if c is None else (c.rows, c.seq),
                {k: tuple(v.shape) for k, v in cache.items()}, sites)

    with torch.no_grad():
        one, wall_one = run(lambda: serve(params, None) if rank == 0
                            else None)
        blocks = rank_local.serve_blocks(cfg, params, layout)
        whole = sum(t.nbytes for t in params.parameters())
        del params
        gc.collect()
        torch.cuda.empty_cache()
        held = sum(t.nbytes for t in blocks.parameters())
        with dctx.axis_rules(mesh, rules):
            got, wall = run_counted(sub, lambda: serve(blocks, tp), want)
    peak = peak_gb()
    toks, logits, cut, cache, sites = got
    rows = b // mesh.extent(cut[0]) if cut else b
    names = tpar.local_names(cfg, mesh, rules)
    n = tp.n if tp is not None else 1
    pre = tpar.serve_collectives(cfg, names, n, rows, s, "prefill")
    dec = tpar.serve_collectives(cfg, names, n, rows, 1, "decode",
                                 seq_cut=bool(cut and cut[1]))
    want_tp = (pre[0] + n_dec * dec[0], pre[1] + n_dec * dec[1])
    g = rank_local.forward_gathers(cfg, layout)
    units = tpar._units(cfg)[0]
    want_st = tuple((n_dec + 1) * (units * g["unit"][i] + g["rest"][i])
                    for i in (0, 1))
    _dist_need(sites["state"] == want_st and sites["tp"] == want_tp,
               f"{sub}: collectives {sites}, want state {want_st} and tp "
               f"{want_tp}")
    err, scale, same = 0.0, 0.0, True
    if rank == 0:
        err = _max_err(logits, one[1])
        scale = float(one[1].abs().max())
        same = bool(torch.equal(toks, one[0]))
    _dist_need(bool(torch.isfinite(logits).all()) and same
               and err <= CUT_DECODE_ATOL,
               f"{sub}: logits max abs err {err:.3e} (tol "
               f"{CUT_DECODE_ATOL}), tokens equal {same}")
    del blocks, one, got, logits
    gc.collect()
    torch.cuda.empty_cache()
    return dict(err=err, max_logit=scale, tokens_equal=same, wall_s=wall,
                wall_one_s=wall_one, peak_gb=peak, cut=cut, cache=cache,
                tp=sites["tp"], state=sites["state"],
                model_cut=tp.axes if tp else (),
                held_bytes=held, whole_bytes=whole)


def phase25i(rank, say, run, run_counted, peak_gb, mesh, rules,
             norms) -> dict:
    """Phase 25i on one of phase 25's ranks: qwen3-4b's serving at full
    width, ``CUT_DECODE_LAYERS`` layers, float32, each rank its
    ``model`` blocks under the --no-fsdp ``rules`` (:func:`serve_on_blocks`):
    its query heads, MLP columns and vocabulary block, the cache cut
    (None, "data", None, "model"), its rows of the batch; held against
    rank 0's one-rank run; launches exact."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("qwen3-4b"),
                              num_layers=CUT_DECODE_LAYERS, dtype="float32")
    b, s, max_seq, n_dec = CUT_DECODE
    L = cfg.num_layers
    r = serve_on_blocks(rank, run, run_counted, peak_gb, mesh, rules, cfg,
                        CUT_DECODE, "25i",
                        {"flash_attention": L,
                         "rmsnorm": (norms(cfg) * L + 1) * (n_dec + 2)})
    _dist_need(r["cut"] == (("data",), ("model",))
               and r["model_cut"] == ("model",) and r["cache"]["k"] == (
                   L, b // mesh.shape["data"], cfg.num_kv_heads,
                   max_seq // mesh.shape["model"], cfg.head_dim),
               f"25i: cut {r['cut']}, model cut {r['model_cut']}, cache "
               f"block {r['cache']['k']}")
    say(f"[25i] qwen3-4b at full width, {L} of 36 layers, float32, N(0, "
        f"{INIT_STD}), {b} x {s:,}-token prompts, {max_seq:,}-slot cache "
        f"cut (None, data, None, model) on {tuple(mesh.shape.values())} "
        f"under make_rules(fsdp=False, data_axes=('data',)): a rank holds "
        f"its model blocks, {r['held_bytes']:,} B of the "
        f"{r['whole_bytes']:,} B of weights (its {cfg.num_heads // 2} of "
        f"{cfg.num_heads} query heads, half the MLP columns and the "
        f"vocabulary, k and v whole), no weight gathered (held); cache "
        f"block {r['cache']['k']}; prefill, {n_dec} decode steps and the "
        f"next logits through the serve steps against rank 0's one-rank "
        f"run: greedy tokens equal {r['tokens_equal']}, logits max abs err "
        f"{r['err']:.3e} (max |logit| {r['max_logit']:.3f}; tol "
        f"{CUT_DECODE_ATOL}); tp collectives {r['tp']} (count, result "
        f"bytes) = serve_collectives (held); launches exact; peak "
        f"{r['peak_gb']:.2f} GB a rank (a whole replica on each rank took "
        f"7.40); wall {r['wall_s']:.2f} s (rank 0 alone, whole, "
        f"{r['wall_one_s']:.2f} s)")
    return r


def phase25l(rank, say, run, run_counted, peak_gb, mesh, rules) -> dict:
    """Phase 25l on one of phase 25's ranks: recurrentgemma-9b's prefill
    and decode at full width, cut to its first pattern group (rec, rec,
    attn), float32, each rank its ``model`` blocks under the --no-fsdp
    ``rules`` (:func:`serve_on_blocks`): its half of the RG-LRU's
    channels (the recurrence on (B, S, di / 2)), of the query heads, the
    MLP columns and the vocabulary; held against rank 0's one-rank run of
    the same cut; launches exact."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"),
                              num_layers=RG_CUT_LAYERS, dtype="float32")
    b, s, max_seq, n_dec = RG_DECODE
    per_forward = 2 * RG_CUT_LAYERS + 1
    r = serve_on_blocks(rank, run, run_counted, peak_gb, mesh, rules, cfg,
                        RG_DECODE, "25l",
                        {"linear_recurrence": 2, "flash_attention": 1,
                         "rmsnorm": per_forward * (n_dec + 2)})
    di = cfg.d_model
    _dist_need(r["model_cut"] == ("model",)
               and r["cache"]["rec_h"][-1] == di // mesh.shape["model"],
               f"25l: model cut {r['model_cut']}, recurrent state "
               f"{r['cache']['rec_h']}")
    say(f"[25l] recurrentgemma-9b at full width, its first pattern group "
        f"(rec, rec, attn), float32, N(0, {INIT_STD}), {b} x {s:,}-token "
        f"prompts, max_seq {max_seq:,}, on {tuple(mesh.shape.values())} "
        f"under make_rules(fsdp=False, data_axes=('data',)): a rank holds "
        f"{r['held_bytes']:,} B of the {r['whole_bytes']:,} B of weights; "
        f"the recurrence on {di // mesh.shape['model']:,} of {di:,} "
        f"channels (recurrent state {r['cache']['rec_h']}), "
        f"{cfg.num_heads // mesh.shape['model']} of {cfg.num_heads} query "
        f"heads; prefill, {n_dec} decode steps and the next logits against "
        f"rank 0's one-rank run: greedy tokens equal {r['tokens_equal']}, "
        f"logits max abs err {r['err']:.3e} (max |logit| "
        f"{r['max_logit']:.3f}; tol {CUT_DECODE_ATOL}); tp collectives "
        f"{r['tp']} = serve_collectives (held); launches exact "
        f"(linear_recurrence 2 a rank, on its channels); peak "
        f"{r['peak_gb']:.2f} GB a rank; wall {r['wall_s']:.2f} s (rank 0 "
        f"alone, whole, {r['wall_one_s']:.2f} s)")
    return r


def phase25j(rank, say, run_counted, peak_gb, mesh, rules, norms) -> dict:
    """Phase 25j on one of phase 25's ranks: qwen2-moe-a2.7b's
    expert-parallel train step (``moe_impl="ep"``) and qwen3-4b's ring
    train step (``ring_attention=True``), each at full width and
    ``REMAT_LAYERS`` layers with bfloat16 weights, rank-local state and
    the rows cut on ``mesh``, under ``axis_rules`` and ``rules``, which
    cut the experts and the query heads over "model": EP reads its block
    of the experts and the ring its query heads, neither gathered over
    "model".  From the same init: one step with ``remat="full"`` and one
    with ``remat="none"``, held bit-equal (loss, gradient norm, every
    updated parameter block), their body collectives as the recompute
    implies (EP's all-to-alls; the ring on heads reads every K/V block
    from its own copy and permutes none); then one step (remat
    none) on the layout that gathers the experts or the heads whole over
    "model" (``J_WHOLE``; the ring on every head permutes K/V, n - 1 a
    layer pass): EP's bit-equal to the step on blocks, the ring's loss
    and norm within ``RING_HEADS_LOSS_REL`` and ``RING_HEADS_NORM_REL``
    (``wo``'s row product is a sum of the ranks' bfloat16 partials on
    heads, and K/V's gradients are summed in another order).  Every step's "state" gathers and "tp"
    collectives (the ring's exchanges of heads for sequence blocks) equal
    the helpers' arithmetic (``rank_local.forward_gathers`` and the
    norm's all-reduce, ``tensor_parallel.step_collectives``); launches
    exact."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed import rank_local
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.models import common as cm
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.utils.comm_stats import record_collectives
    from repro_torch.utils.tree import tree_leaves

    cuda = torch.device(DIST_DEVICE)
    cases = (
        ("ep", dataclasses.replace(
            get_config("qwen2-moe-a2.7b"), num_layers=REMAT_LAYERS,
            moe_impl="ep", moe_expert_pad=0, param_dtype="bfloat16"),
         "all-to-all", {"blocks": 2, "whole": 2}),
        # the ring on heads reads every K/V block from its own copy
        ("ring", dataclasses.replace(
            get_config("qwen3-4b"), num_layers=REMAT_LAYERS,
            ring_attention=True, param_dtype="bfloat16"),
         "collective-permute",
         {"blocks": 0, "whole": mesh.shape["model"] - 1}))
    rows = REMAT_BATCH[0] // mesh.shape["data"]
    out = {}
    for name, base, kind, per_layer in cases:
        batch = {"tokens": np.random.default_rng(5).integers(
            0, base.vocab_size, REMAT_BATCH)}
        names = tpar.local_names(base, mesh, rules)
        _dist_need(J_WHOLE[name] in names,
                   f"25j {name}: the rules compute {sorted(names)}, not "
                   f"{J_WHOLE[name]} on blocks")
        specs = rank_local.specs_for(base, mesh, rules)
        layouts = {
            "blocks": (rank_local.layout_for(base, mesh, rules), names),
            "whole": (rank_local.Layout(
                mesh, specs, rules, rank_local.gathered_specs(
                    base, specs.params, mesh, rules,
                    names - {J_WHOLE[name]})), names - {J_WHOLE[name]})}
        res = {}
        for run_name, form, remat in (("full", "blocks", "full"),
                                      ("none", "blocks", "none"),
                                      ("whole", "whole", "none")):
            cfg = dataclasses.replace(base, remat=remat)
            layout, lnames = layouts[form]
            tp = layout.model_cut()
            L = cfg.num_layers
            runs = cm.layer_forward_runs(cfg, L)
            state = rank_local.init_state(
                cfg, layout, torch.Generator(cuda).manual_seed(0),
                device=cuda, weight_std=INIT_STD)
            step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=0,
                                                    total_steps=8))
            attn = 0 if name == "ring" else 1
            want = {"flash_attention": attn * runs,
                    "flash_attention_bwd": attn * L,
                    "rmsnorm": norms(cfg) * runs + 1,
                    "rmsnorm_bwd": norms(cfg) * L + 1}

            def train():
                with dctx.axis_rules(mesh, rules), \
                        record_collectives() as rec:
                    _, m = step(state, batch)
                return ((float(m["loss"]), float(m["grad_norm"])),
                        rec.stats("body").count[kind],
                        {site: (sum(rec.stats(site).count.values()),
                                int(rec.stats(site).total_result_bytes))
                         for site in ("state", "tp")})

            (metrics, n_coll, sites), wall = run_counted(
                f"25j {name} {run_name}", train, want)
            peak = peak_gb()
            _dist_need(n_coll == per_layer[form] * (runs + L),
                       f"25j {name} {run_name}: {n_coll} {kind}s, want "
                       f"{per_layer[form]} x ({runs} layer forwards + {L} "
                       f"backwards)")
            arith = {"state": rank_local.step_gathers(cfg, layout),
                     "tp": tpar.step_collectives(
                         cfg, lnames, tp.n, rows, REMAT_BATCH[1])}
            for site, got in sites.items():
                _dist_need(got == tuple(arith[site]),
                           f"25j {name} {run_name}: {site} collectives "
                           f"{got}, the arithmetic {arith[site]}")
            res[run_name] = dict(
                metrics=metrics, coll=n_coll, wall_s=wall, peak_gb=peak,
                state=sites["state"], tp=sites["tp"],
                blocks=[t.detach().clone() for t in
                        tree_leaves(state.params.param_tree())])
            del state, step
            gc.collect()
            torch.cuda.empty_cache()

        def same(a, b):
            return (res[a]["metrics"] == res[b]["metrics"]
                    and all(torch.equal(x, y) for x, y in
                            zip(res[a]["blocks"], res[b]["blocks"])))
        _dist_need(same("full", "none"),
                   f"25j {name}: remat full {res['full']['metrics']} "
                   f"differs from remat none {res['none']['metrics']}")
        (loss, norm), (w_loss, w_norm) = (res["none"]["metrics"],
                                          res["whole"]["metrics"])
        loss_rel = abs(loss - w_loss) / abs(w_loss)
        norm_rel = abs(norm - w_norm) / abs(w_norm)
        if name == "ep":
            _dist_need(same("none", "whole"),
                       f"25j ep: on its expert blocks {res['none']['metrics']}"
                       f" differs from the whole experts' step "
                       f"{res['whole']['metrics']}")
            against = "bit-equal, every updated block too (held)"
        else:
            _dist_need(loss_rel <= RING_HEADS_LOSS_REL
                       and norm_rel <= RING_HEADS_NORM_REL,
                       f"25j ring: on heads (loss, norm) {(loss, norm)}, "
                       f"on whole heads {(w_loss, w_norm)}: rel "
                       f"{loss_rel:.3e} / {norm_rel:.3e}")
            against = (f"loss rel {loss_rel:.3e} (tol "
                       f"{RING_HEADS_LOSS_REL}), norm rel {norm_rel:.3e} "
                       f"(tol {RING_HEADS_NORM_REL}) (held)")
        say(f"[25j] {base.name} {name} train step at full width, "
            f"{base.num_layers} layers, bfloat16 weights and activations, "
            f"{REMAT_BATCH[0]} x {REMAT_BATCH[1]:,} tokens, each rank its "
            f"{rows} rows on {tuple(mesh.shape.values())}, its "
            f"{J_WHOLE[name]} on blocks: remat full (loss, grad norm) "
            f"{res['full']['metrics']} bit-equal to remat none "
            f"{res['none']['metrics']}, every updated block too (held); "
            f"{kind}s {res['full']['coll']} with the recompute / "
            f"{res['none']['coll']} without / {res['whole']['coll']} on "
            f"the whole layout (held); against the layout "
            f"that gathers the {J_WHOLE[name]} whole "
            f"{res['whole']['metrics']}: {against}; launches exact")
        for run_name, r in res.items():
            say(f"[25j] {name} {run_name}: state gathers (count, result "
                f"bytes, the norm's 4-byte all-reduce among them) "
                f"{r['state']}, tp {r['tp']} (both the arithmetic, held); "
                f"peak {r['peak_gb']:.2f} GB a rank; wall "
                f"{r['wall_s']:.2f} s (gloo)")
        out[name] = {k: {kk: v[kk] for kk in ("metrics", "coll", "wall_s",
                                              "peak_gb", "state", "tp")}
                     for k, v in res.items()}
        out[name]["rel_to_whole"] = (loss_rel, norm_rel)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase25h(rank, say, run_counted, mesh, rules, p18) -> dict:
    """Phase 25h on one of phase 25's ranks: tinyllama-1.1b at full width
    and depth trained with rank-local state on ``mesh`` under ``rules``
    (``RL_RULES``: FSDP over both axes, nothing on "model": each rank
    holds its blocks of params, m and v, gathers a layer's weights whole
    where the step reads them, computes its rows of the batch and sums
    the gradient over the data axis), as phase 18 trains it (seed 0,
    N(0, 0.02), bfloat16 activations, remat full, 4 x 2,048 tokens from
    TokenPipeline, lr 3e-3, 2 warmup steps of 8), ``RL_STEPS`` steps held
    against phase 18's losses and gradient norms (``p18``), with exact
    kernel launches, each rank's state bytes and peak, and the
    all-gathers' and the gradient sums' bytes against their
    arithmetic."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import models as M
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import rank_local
    from repro_torch.launch.dryrun import _sharded_bytes
    from repro_torch.models import common as cm
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import (
        make_train_step, state_logical_axes, state_spec)
    from repro_torch.utils.comm_stats import record_collectives
    from repro_torch.utils.tree import tree_leaves

    cuda = torch.device(DIST_DEVICE)
    cfg = get_config("tinyllama-1.1b")
    L = cfg.num_layers
    runs = cm.layer_forward_runs(cfg, L)
    layout = rank_local.layout_for(cfg, mesh, rules)

    def each_rank(x: float) -> list:
        t = torch.tensor([x], device=cuda)
        parts = [torch.empty_like(t) for _ in range(mesh.size)]
        dist.all_gather(parts, t)
        return [float(p) for p in parts]

    torch.cuda.synchronize()
    dist.barrier()
    # what a rank still holds from the sub-phases before (none expected)
    held_before = each_rank(torch.cuda.memory_allocated() / 1e9)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state = rank_local.init_state(cfg, layout,
                                  torch.Generator(cuda).manual_seed(0),
                                  device=cuda, weight_std=INIT_STD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    init_peaks = each_rank(torch.cuda.max_memory_allocated() / 1e9)
    held = {}
    for tensor in (list(state.params.parameters())
                   + tree_leaves({"p": state.params.param_tree(),
                                  "o": state.opt})):
        st = tensor.untyped_storage()
        held[st._cdata] = st.nbytes()
    spec, axes = state_spec(cfg), state_logical_axes(cfg)
    want_bytes = sum(_sharded_bytes(getattr(spec, k), getattr(axes, k),
                                    mesh, rules) for k in ("params", "opt"))
    state_bytes = each_rank(sum(held.values()))
    _dist_need(all(b == want_bytes for b in state_bytes),
               f"25h: state bytes a rank {state_bytes}, the blocks' "
               f"{want_bytes}")
    data = TokenPipeline(DataConfig(cfg.vocab_size, RL_BATCH[1],
                                    RL_BATCH[0]))
    step = make_train_step(cfg, AdamWConfig(lr=3e-3, warmup_steps=2,
                                            total_steps=8))
    per_step = {"rmsnorm": 2 * runs + 1, "rmsnorm_bwd": 2 * L + 1,
                "flash_attention": runs, "flash_attention_bwd": L}
    n_steps = RL_STEPS

    def train():
        nonlocal state
        out = []
        with record_collectives() as rec:
            for _ in range(n_steps):
                state, m = step(state, next(data))
                out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, {site: rec.stats(site).as_dict()
                     for site in ("state", "grad", "rows")}

    (metrics, by_site), wall = run_counted(
        "25h", train, {k: n_steps * v for k, v in per_step.items()})
    stats, grad = by_site["state"], by_site["grad"]
    peaks = each_rank(torch.cuda.max_memory_allocated() / 1e9)
    fwd = rank_local.forward_gathers(cfg, layout)
    n_gather = runs * fwd["unit"][0] + fwd["rest"][0]
    gather_bytes = runs * fwd["unit"][1] + fwd["rest"][1]
    got_n = stats["count"]["all-gather"]
    got_b = stats["result_bytes"]["all-gather"]
    _dist_need(got_n == n_steps * n_gather and got_b == n_steps * gather_bytes,
               f"25h: all-gathers {got_n} of {got_b:,.0f} B, the arithmetic "
               f"{n_steps} x ({n_gather} of {gather_bytes:,} B)")
    _dist_need(stats["count"]["all-reduce"] == n_steps,
               f"25h: the norm's all-reduces {stats['count']}")
    # the gradient's sums over "data": a read's backward once a read of
    # the forward (L layer reads, the recomputes' none), the leaves held
    # whole once a step; the metrics' mean once a step
    sums = rank_local.backward_sums(cfg, layout, ("data",))
    n_sum = L * sums["unit"][0] + sums["rest"][0] + sums["whole"][0]
    sum_bytes = L * sums["unit"][1] + sums["rest"][1] + sums["whole"][1]
    got_sn = sum(grad["count"].values())
    got_sb = sum(grad["result_bytes"].values())
    _dist_need(got_sn == n_steps * n_sum and got_sb == n_steps * sum_bytes,
               f"25h: gradient sums {grad['count']} of {got_sb:,.0f} B, the "
               f"arithmetic {n_steps} x ({n_sum} of {sum_bytes:,} B)")
    _dist_need(by_site["rows"]["count"]["all-reduce"] == n_steps,
               f"25h: the metrics' means {by_site['rows']['count']}")
    # against phase 18: the losses of the steps that read its weights
    # (None: printed, not held) and every norm; against its step in two
    # microbatches of a rank's rows: every loss and norm
    tols = {"18": [(RL_LOSS_REL if i < 2 else None, RL_NORM_REL)
                   for i in range(n_steps)],
            "mb2": [(RL_MB2_LOSS_REL, RL_MB2_NORM_REL)] * n_steps}
    errs = []
    for i, (loss, norm) in enumerate(metrics):
        e = dict(loss=loss, norm=norm)
        for key, ref in (("18", p18), ("mb2", p18["mb2"])):
            want_l, want_n = ref["losses"][i], ref["grad_norms"][i]
            e[key] = dict(loss=want_l, loss_rel=abs(loss - want_l) / abs(want_l),
                          norm=want_n, norm_rel=abs(norm - want_n) / abs(want_n))
        errs.append(e)
    gib = want_bytes / 1e9
    say(f"[25h] tinyllama-1.1b at full width and depth "
        f"({M.count_params(cfg):,} float32 parameters, seed 0, N(0, {INIT_STD})), "
        f"bfloat16 activations, remat full, {RL_BATCH[0]} x "
        f"{RL_BATCH[1]:,} tokens, each rank its "
        f"{RL_BATCH[0] // mesh.shape['data']} rows, rank-local state on mesh "
        f"{tuple(mesh.shape.values())} (data, model) under FSDP over both "
        f"axes and nothing on model (every weight gathered whole): each "
        f"rank holds "
        f"{int(state_bytes[0]):,} B of params, m and v blocks ({gib:.3f} "
        f"GB; every rank {[int(b) for b in state_bytes]}; the blocks' bytes "
        f"from the specs {want_bytes:,}); init {init_s:.2f} s, init peaks "
        f"{[round(p, 2) for p in init_peaks]} GB (the global parameters "
        f"drawn on each rank, then cut), of which held from 25a-25f "
        f"{[round(p, 3) for p in held_before]} GB")
    for i, e in enumerate(errs):
        (l18, n18), (lmb, nmb) = tols["18"][i], tols["mb2"][i]
        say(f"[25h] step {i + 1}{' (weights moved)' if i >= 2 else ''}: "
            f"loss {e['loss']!r}, grad norm {e['norm']!r}; phase 18's "
            f"{e['18']['loss']!r}, {e['18']['norm']!r} (rel "
            f"{e['18']['loss_rel']:.3e}, tol "
            f"{l18 if l18 is not None else 'none: printed'}; "
            f"{e['18']['norm_rel']:.3e}, tol {n18}); phase 18's step in "
            f"{RL_MB2} microbatches of a rank's rows {e['mb2']['loss']!r}, "
            f"{e['mb2']['norm']!r} (rel {e['mb2']['loss_rel']:.3e}, tol "
            f"{lmb}; {e['mb2']['norm_rel']:.3e}, tol {nmb})")
    say(f"[25h] {n_steps} steps: peak memory a rank "
        f"{[round(p, 2) for p in peaks]} GB (phase 18, one rank with the "
        f"whole state: {p18['peak_gb']:.2f} GB); all-gathers {got_n} of "
        f"{got_b:,.0f} result bytes a rank, the arithmetic {n_steps} x "
        f"({n_gather} of {gather_bytes:,} B: each layer's sharded leaves "
        f"once a layer forward, {runs} a step with the recomputes, and the "
        f"embedding, final norm and head once) (held); gradient sums over "
        f"data {grad['count']} of {got_sb:,.0f} result bytes, the "
        f"arithmetic {n_steps} x ({n_sum} of {sum_bytes:,} B: a "
        f"reduce-scatter a read's sharded weight, an all-reduce a leaf "
        f"held whole) (held); the norm's all-reduces "
        f"{stats['count']['all-reduce']}; launches a rank "
        f"{n_steps} x {per_step} (held); wall {wall:.2f} s (gloo's host "
        f"staging of the gathers and the sums on one shared card, not the "
        f"link)")
    for i, e in enumerate(errs):
        _dist_need(bool(np.isfinite(e["loss"])),
                   f"25h: step {i + 1} loss {e['loss']!r}")
        for key, what in (("18", "phase 18's"),
                          ("mb2", f"phase 18's {RL_MB2}-microbatch")):
            tol_l, tol_n = tols[key][i]
            r = e[key]
            _dist_need(tol_l is None or r["loss_rel"] <= tol_l,
                       f"25h: step {i + 1} loss {e['loss']!r} against "
                       f"{what} {r['loss']!r}: rel {r['loss_rel']:.3e} > "
                       f"{tol_l}")
            _dist_need(r["norm_rel"] <= tol_n,
                       f"25h: step {i + 1} grad norm {e['norm']!r} against "
                       f"{what} {r['norm']!r}: rel {r['norm_rel']:.3e} > "
                       f"{tol_n}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(steps=errs, wall_s=wall, init_s=init_s, peaks_gb=peaks,
                init_peaks_gb=init_peaks, held_before_gb=held_before,
                state_bytes=state_bytes,
                gathers=got_n, gather_bytes=got_b, sums=grad["count"],
                sum_bytes=got_sb)


def phase25k(rank, say, run_counted, mesh, rules, h) -> dict:
    """Phase 25k on one of phase 25's ranks: 25h's three steps (the same
    seed, weights and batches) tensor-parallel over ``model`` under
    ``rules`` (the default: heads, MLP columns and vocabulary on
    "model", rows on "data"): each rank computes its 2 of the 4 rows and
    its 16 of the 32 query heads, 2,816 of the 5,632 MLP columns and
    16,000 of the 32,000 vocabulary rows.  Each step's loss and norm
    against 25h's ``h`` within ``TP_LOSS_REL`` (steps 1-2, which read
    25h's weights; step 3's printed) and ``TP_NORM_REL``; the
    ``"tp"`` collectives, the weights' all-gathers over "data" and the
    gradient's sums held to ``tensor_parallel.step_collectives``,
    ``rank_local.forward_gathers`` and ``backward_sums``; launches as
    25h's (each attention and RMSNorm launch on the rank's heads)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import rank_local
    from repro_torch.models import common as cm

    cfg = get_config("tinyllama-1.1b")
    L = cfg.num_layers
    runs = cm.layer_forward_runs(cfg, L)
    layout = rank_local.layout_for(cfg, mesh, rules)
    per_step = {"rmsnorm": 2 * runs + 1, "rmsnorm_bwd": 2 * L + 1,
                "flash_attention": runs, "flash_attention_bwd": L}
    r = _tp_train(rank, run_counted, mesh, cfg, layout, "25k", per_step,
                  RL_STEPS, RL_BATCH,
                  dict(lr=3e-3, warmup_steps=2, total_steps=8))
    tp, sites, n_steps = r["tp"], r["sites"], RL_STEPS
    _dist_need(tp is not None and tp.axes == ("model",)
               and r["names"] == ["heads", "mlp", "vocab"],
               f"25k: model cut {tp}, local names {r['names']}")
    say(f"[25k] tinyllama-1.1b at full width and depth, 25h's seed, "
        f"weights and batches, tensor-parallel on "
        f"{tuple(mesh.shape.values())} under make_rules(data_axes="
        f"('data',)): each rank its {r['rows']} of {RL_BATCH[0]} rows, "
        f"{cfg.num_heads // tp.n} of {cfg.num_heads} query heads (k and v "
        f"whole), {cfg.d_ff // tp.n:,} of {cfg.d_ff:,} MLP columns, "
        f"{cfg.vocab_size // tp.n:,} of {cfg.vocab_size:,} vocabulary rows; "
        f"tp collectives {sites['tp'][0]} of {sites['tp'][1]:,} result "
        f"bytes, the arithmetic (held); all-gathers over data "
        f"{r['gathers'][0]} of {r['gathers'][1]:,} B (held; 25h "
        f"{h['gathers']} of {h['gather_bytes']:,.0f} B); gradient sums "
        f"{sites['grad'][0]} of {sites['grad'][1]:,} B (held); launches "
        f"{n_steps} x {per_step}, 25h's (held); peak a rank "
        f"{r['peaks_gb']} GB (25h {[round(p, 2) for p in h['peaks_gb']]}); "
        f"wall {r['wall_s']:.2f} s (25h {h['wall_s']:.2f} s; gloo's host "
        f"staging)")
    # the losses of the steps that read 25h's weights are held, step 3's
    # printed (it reads weights step 2's updates moved); every norm held
    errs = _hold_steps(say, "25k", r["metrics"],
                       ([e["loss"] for e in h["steps"]],
                        [e["norm"] for e in h["steps"]]), "25h's", held=2)
    return dict(steps=errs, wall_s=r["wall_s"], peaks_gb=r["peaks_gb"],
                tp=sites["tp"], state=sites["state"], grad=sites["grad"])


def _tp_train(rank, run_counted, mesh, cfg, layout, sub, per_step, n_steps,
              batch, lr_cfg) -> dict:
    """``n_steps`` train steps of ``cfg`` on a rank-local state of
    ``layout`` (seed 0, N(0, ``INIT_STD``), batches of
    ``TokenPipeline(batch)``, AdamW ``lr_cfg``), counted as ``sub``
    (``per_step`` launches a step, held); returns the steps' (loss, norm),
    the sites' collectives, their arithmetic, the wall and each rank's
    peak."""
    import torch
    import torch.distributed as dist

    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import rank_local
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.models import common as cm
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    from repro_torch.utils.comm_stats import record_collectives

    cuda = torch.device(DIST_DEVICE)
    torch.cuda.reset_peak_memory_stats()
    state = rank_local.init_state(cfg, layout,
                                  torch.Generator(cuda).manual_seed(0),
                                  device=cuda, weight_std=INIT_STD)
    data = TokenPipeline(DataConfig(cfg.vocab_size, batch[1], batch[0]))
    step = make_train_step(cfg, AdamWConfig(**lr_cfg))

    def train():
        nonlocal state
        out = []
        with record_collectives() as rec:
            for _ in range(n_steps):
                state, m = step(state, next(data))
                out.append((float(m["loss"]), float(m["grad_norm"])))
        return out, {site: (sum(rec.stats(site).count.values()),
                            int(rec.stats(site).total_result_bytes))
                     for site in ("tp", "state", "grad")}

    (metrics, sites), wall = run_counted(
        sub, train, {k: n_steps * v for k, v in per_step.items()})
    t = torch.tensor([torch.cuda.max_memory_allocated() / 1e9], device=cuda)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    units = tpar._units(cfg)[0]
    runs = cm.layer_forward_runs(cfg, units)
    tp = layout.model_cut()
    names = tpar.local_names(cfg, mesh, layout.rules)
    rows = batch[0] // mesh.shape["data"]
    fwd = rank_local.forward_gathers(cfg, layout)
    sums = rank_local.backward_sums(cfg, layout, ("data",))
    tp_n, tp_b = tpar.step_collectives(cfg, names, tp.n, rows, batch[1])
    st_n, st_b = rank_local.step_gathers(cfg, layout)
    want = {"tp": (n_steps * tp_n, n_steps * tp_b),
            "state": (n_steps * st_n, n_steps * st_b),
            "grad": (n_steps * (units * sums["unit"][0] + sums["rest"][0]
                                + sums["whole"][0]),
                     n_steps * (units * sums["unit"][1] + sums["rest"][1]
                                + sums["whole"][1]))}
    for site, (n, nbytes) in want.items():
        _dist_need(sites[site] == (n, nbytes),
                   f"{sub}: {site} collectives {sites[site]}, the "
                   f"arithmetic {(n, nbytes)}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(metrics=metrics, sites=sites, wall_s=wall, rows=rows,
                peaks_gb=[round(float(p), 2) for p in parts],
                names=sorted(names), tp=tp,
                gathers=(n_steps * (runs * fwd["unit"][0] + fwd["rest"][0]),
                         n_steps * (runs * fwd["unit"][1] + fwd["rest"][1])))


def _hold_steps(say, sub, metrics, ref, what, held=None) -> list:
    """Each step's loss and norm against ``ref``'s ``(losses, norms)``,
    printed and held within ``TP_LOSS_REL`` and ``TP_NORM_REL``; past the
    first ``held`` steps (None: all) the loss is printed, not held (those
    steps read weights that earlier updates moved)."""
    import numpy as np
    errs = []
    for i, (loss, norm) in enumerate(metrics):
        rl, rn = ref[0][i], ref[1][i]
        tol = TP_LOSS_REL if held is None or i < held else None
        e = dict(loss=loss, norm=norm, ref_loss=rl, ref_norm=rn,
                 loss_rel=abs(loss - rl) / abs(rl),
                 norm_rel=abs(norm - rn) / abs(rn))
        errs.append(e)
        say(f"[{sub}] step {i + 1}{'' if tol else ' (weights moved)'}: "
            f"loss {loss!r}, grad norm {norm!r}; {what} {rl!r}, {rn!r} (rel "
            f"{e['loss_rel']:.3e}, tol {tol or 'none: printed'}; "
            f"{e['norm_rel']:.3e}, tol {TP_NORM_REL})")
        _dist_need(bool(np.isfinite(loss))
                   and (tol is None or e["loss_rel"] <= tol)
                   and e["norm_rel"] <= TP_NORM_REL,
                   f"{sub}: step {i + 1} loss {loss!r} / norm {norm!r} "
                   f"against {what} {rl!r} / {rn!r}: rel "
                   f"{e['loss_rel']:.3e} (tol {tol}), {e['norm_rel']:.3e} "
                   f"(tol {TP_NORM_REL})")
    return errs


def phase25n(rank, say, run_counted, mesh, rules, k) -> dict:
    """Phase 25n on one of phase 25's ranks: 25k's first step (the same
    seed, weights, batch and rules) under Megatron's sequence parallelism
    (``seq_parallel``): between the sublayers a rank holds its 1,024 of
    the 2,048 positions, all-gathered into each sublayer and
    reduce-scattered out.  Its loss and norm against 25k's step 1 within
    ``TP_LOSS_REL`` / ``TP_NORM_REL``; the ``"tp"`` collectives (the
    sequence's all-gathers and reduce-scatters among them), the gathers
    over "data" and the gradient sums held to their arithmetic; launches
    as 25k's; the peak a rank printed beside 25k's."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import rank_local
    from repro_torch.models import common as cm

    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              seq_parallel=True)
    L = cfg.num_layers
    runs = cm.layer_forward_runs(cfg, L)
    layout = rank_local.layout_for(cfg, mesh, rules)
    per_step = {"rmsnorm": 2 * runs + 1, "rmsnorm_bwd": 2 * L + 1,
                "flash_attention": runs, "flash_attention_bwd": L}
    r = _tp_train(rank, run_counted, mesh, cfg, layout, "25n", per_step, 1,
                  RL_BATCH, dict(lr=3e-3, warmup_steps=2, total_steps=8))
    sites = r["sites"]
    say(f"[25n] tinyllama-1.1b at full width and depth, 25k's seed, "
        f"weights, batch and rules, with seq_parallel: each rank its "
        f"{r['rows']} of {RL_BATCH[0]} rows and 25k's blocks of the heads, "
        f"MLP columns and vocabulary, and between the sublayers its "
        f"{RL_BATCH[1] // r['tp'].n:,} of {RL_BATCH[1]:,} positions; tp "
        f"collectives {sites['tp'][0]} of {sites['tp'][1]:,} result bytes "
        f"= step_collectives with the sequence's all-gathers and "
        f"reduce-scatters (held; 25k's a step {k['tp'][0] // RL_STEPS} of "
        f"{k['tp'][1] // RL_STEPS:,}); all-gathers over data "
        f"{sites['state'][0]} of {sites['state'][1]:,} B, gradient sums "
        f"{sites['grad'][0]} of {sites['grad'][1]:,} B (held); launches "
        f"{per_step}, 25k's a step (held); peak a rank {r['peaks_gb']} GB "
        f"(25k {k['peaks_gb']}); wall {r['wall_s']:.2f} s (one step; 25k "
        f"{k['wall_s']:.2f} s for {RL_STEPS})")
    step1 = k["steps"][0]
    errs = _hold_steps(say, "25n", r["metrics"],
                       ([step1["loss"]], [step1["norm"]]), "25k step 1's")
    return dict(steps=errs, wall_s=r["wall_s"], peaks_gb=r["peaks_gb"],
                tp=sites["tp"], state=sites["state"], grad=sites["grad"])


def phase25m(rank, say, run, run_counted, peak_gb, mesh, rules,
             serve_rules, p23) -> dict:
    """Phase 25m on one of phase 25's ranks: mamba2-370m at full width
    and depth on a rank's heads.  Training under ``rules`` (the
    default: "ssm_inner" and the vocabulary on "model", rows on "data"):
    each rank its 2 of the 4 rows and its 16 of the 32 heads (``in_proj``
    and the conv gathered whole and its columns sliced, ``out_proj`` and
    the gated norm's weight read as its blocks, the gated norm's squares
    and dot products summed over "model" by the ``rmsnorm_cut`` kernels),
    ``MAMBA_STEPS`` steps of phase 23's seed, weights, batches and
    learning rate held against phase 23's (``p23``) within
    ``TP_LOSS_REL`` / ``TP_NORM_REL``, the collectives held to their
    arithmetic, launches exact (the SSD and cut-norm kernels on every
    rank).  Then serving under ``serve_rules``
    (:func:`serve_on_blocks`): a prefill and decode steps of
    ``MAMBA_DECODE`` in float32 on the rank's heads, the cache its heads'
    state, against rank 0's one-rank run."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import rank_local
    from repro_torch.models import common as cm

    t = time.perf_counter()
    cfg = get_config("mamba2-370m")
    L = cfg.num_layers
    runs = cm.layer_forward_runs(cfg, L)
    layout = rank_local.layout_for(cfg, mesh, rules)
    per_step = {"rmsnorm": runs + 1, "rmsnorm_bwd": L + 1,
                "rmsnorm_cut": runs, "rmsnorm_cut_bwd": L,
                "ssd_chunk_scan": runs, "ssd_chunk_scan_bwd": L}
    r = _tp_train(rank, run_counted, mesh, cfg, layout, "25m", per_step,
                  MAMBA_STEPS, (4, 2048),
                  dict(lr=RECURRENT_LR["23"], warmup_steps=2,
                       total_steps=4))
    tp, sites = r["tp"], r["sites"]
    _dist_need(tp is not None and tp.axes == ("model",)
               and "ssm_inner" in r["names"],
               f"25m: model cut {tp}, local names {r['names']}")
    hl = cfg.ssm_heads // tp.n
    say(f"[25m] mamba2-370m at full width and depth ({L} layers), phase "
        f"23's seed, weights, batches and lr {RECURRENT_LR['23']}, on "
        f"{tuple(mesh.shape.values())} under make_rules(data_axes="
        f"('data',)): each rank its {r['rows']} of 4 rows, {hl} of "
        f"{cfg.ssm_heads} heads ({hl * cfg.ssm_headdim:,} of "
        f"{cfg.d_inner:,} gated-norm columns, summed over model by "
        f"rmsnorm_cut), local names {r['names']}; tp collectives "
        f"{sites['tp'][0]} of {sites['tp'][1]:,} result bytes (held); "
        f"gathers {sites['state'][0]} of {sites['state'][1]:,} B (held: "
        f"in_proj and the conv over data and model); gradient sums "
        f"{sites['grad'][0]} of {sites['grad'][1]:,} B (held); launches "
        f"{MAMBA_STEPS} x {per_step} (held); peak a rank {r['peaks_gb']} "
        f"GB; wall {r['wall_s']:.2f} s (gloo's host staging)")
    errs = _hold_steps(say, "25m", r["metrics"],
                       (p23["losses"][:MAMBA_STEPS],
                        p23["grad_norms"][:MAMBA_STEPS]), "phase 23's")
    scfg = dataclasses.replace(cfg, dtype="float32")
    b, s, max_seq, n_dec = MAMBA_DECODE
    fwd = n_dec + 2
    sv = serve_on_blocks(rank, run, run_counted, peak_gb, mesh, serve_rules,
                         scfg, MAMBA_DECODE, "25m serve",
                         {"ssd_chunk_scan": L, "rmsnorm": (L + 1) * fwd,
                          "rmsnorm_cut": L * fwd})
    conv = hl * cfg.ssm_headdim + 2 * cfg.ssm_groups * cfg.ssm_state
    want_cache = {"ssm": (L, b // mesh.shape["data"], hl, cfg.ssm_headdim,
                          cfg.ssm_state),
                  "conv": (L, b // mesh.shape["data"], cfg.conv_width - 1,
                           conv)}
    _dist_need(sv["model_cut"] == ("model",) and sv["cache"] == want_cache,
               f"25m serve: model cut {sv['model_cut']}, cache {sv['cache']}"
               f", want {want_cache}")
    say(f"[25m] serving, float32, N(0, {INIT_STD}), {b} x {s:,}-token "
        f"prompts, max_seq {max_seq:,}, under make_rules(fsdp=False, "
        f"data_axes=('data',)): a rank holds {sv['held_bytes']:,} B of the "
        f"{sv['whole_bytes']:,} B of weights; cache block {sv['cache']} "
        f"(its heads' state and conv tail, B and C whole: the port's own "
        f"cut); prefill, {n_dec} decode steps and the next logits against "
        f"rank 0's one-rank run: greedy tokens equal {sv['tokens_equal']}, "
        f"logits max abs err {sv['err']:.3e} (max |logit| "
        f"{sv['max_logit']:.3f}; tol {CUT_DECODE_ATOL}); tp collectives "
        f"{sv['tp']} = serve_collectives, in_proj and conv gathers "
        f"{sv['state']} = forward_gathers (held); launches exact; peak "
        f"{sv['peak_gb']:.2f} GB a rank; wall {sv['wall_s']:.2f} s (rank 0 "
        f"alone, whole, {sv['wall_one_s']:.2f} s)")
    wall = time.perf_counter() - t
    say(f"[25m] 25m took {wall:.1f} s")
    return dict(steps=errs, wall_s=r["wall_s"], peaks_gb=r["peaks_gb"],
                tp=sites["tp"], state=sites["state"], grad=sites["grad"],
                serve={k: v for k, v in sv.items() if k != "cut"},
                phase_wall_s=wall)


def _leaf_paths(tree, prefix=""):
    """``(path, leaf)`` of a tree of dicts, in sorted-key order."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for k in sorted(tree):
        yield from _leaf_paths(tree[k], f"{prefix}/{k}" if prefix else k)


def phase25g_rank(rank, report):
    """Phase 25g: a world of one rank on NCCL: ring attention at 25a's
    shape on a (1, 1) mesh and flash-decode at 25c's, against the plain
    results."""
    import torch

    from repro_torch.distributed.flash_decode import flash_decode
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.ring_attention import ring_attention
    from repro_torch.kernels import ref as kref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = Mesh((1, 1), ("data", "model"), backend="nccl",
                device=DIST_DEVICE)
    w = torch.ones(256, 256, device=DIST_DEVICE)
    torch.distributed.all_reduce(w @ w)      # cuBLAS and NCCL start-up
    torch.cuda.synchronize()
    q, k, v = _ring_inputs()
    t = time.perf_counter()
    out = ring_attention(mesh, q, k, v, causal=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    err = _max_err(out, kref.attention_ref(q, k, v, causal=True))
    _dist_need(err <= RING_ATOL, f"25g ring: max abs err {err:.3e}")
    del q, k, v, out
    q, ck, cv = _decode_inputs()
    pos = DECODE_SHAPE[-1]
    t = time.perf_counter()
    out = flash_decode(mesh, q, ck, cv, pos)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t
    err_d = _max_err(out, _dense_decode(q, ck, cv, pos))
    _dist_need(err_d <= DECODE_ATOL, f"25g decode: max abs err {err_d:.3e}")
    report(f"[25g] one rank on NCCL, mesh (1, 1): ring attention at 25a's "
           f"shape max abs err {err:.3e} (tol {RING_ATOL}, wall "
           f"{wall * 1e3:.1f} ms), flash-decode at 25c's {err_d:.3e} (tol "
           f"{DECODE_ATOL}, wall {wall_d * 1e3:.1f} ms), against the plain "
           f"results")
    return dict(ring_err=err, decode_err=err_d)


def recurrent_argv(phase: str, arch: str, batch: int, seq: int) -> list:
    """``launch.train``'s arguments of phases 23-24's four steps (seed 0,
    N(0, ``INIT_STD``), ``RECURRENT_LR``, two warmup steps)."""
    return ["--arch", arch, "--batch", str(batch), "--seq-len", str(seq),
            "--lr", str(RECURRENT_LR[phase]), "--warmup", "2",
            "--log-every", "1", "--init-std", str(INIT_STD), "--steps", "4",
            "--seed", "0"]


def rl_reference(train_args: list) -> dict:
    """25h's exact reference: phase 18's run (``train_args``, 8 steps,
    seed 0) with its batch in ``RL_MB2`` microbatches, slice i the rows
    of the rank of data index i: its first ``RL_STEPS`` losses and
    gradient norms.  Its launches count nowhere (not a phase's run)."""
    import torch
    from repro_torch.launch import train as ltrain
    res = ltrain.main(train_args + ["--steps", "8", "--seed", "0",
                                    "--microbatches", str(RL_MB2)])
    out = dict(losses=res["losses"][:RL_STEPS],
               grad_norms=res["grad_norms"][:RL_STEPS])
    del res
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase25(p18: dict, p23: dict):
    """Phase 25 from the parent: the four gloo ranks (25a-25f, 25h held
    against phase 18's numbers ``p18``, 25i, 25j, 25k-25n, 25m against
    phase 23's ``p23``), then the NCCL world of one (25g); returns the
    kernel launches of the ranks' distributed runs, summed.  Fails the
    script when a rank fails, a world hangs or a kernel of the path was
    never launched."""
    from repro_torch.distributed import launch as dlaunch
    t = time.perf_counter()

    def show(rank, line):
        if line is not None:
            print(line, flush=True)

    try:
        res = dlaunch.run(phase25_rank, 4, backend="gloo",
                          device=DIST_DEVICE, timeout=DIST_TIMEOUT,
                          args=(p18, p23), on_message=show)
        dlaunch.run(phase25g_rank, 1, backend="nccl", device=DIST_DEVICE,
                    timeout=DIST_TIMEOUT, on_message=show)
    except (RuntimeError, TimeoutError) as e:
        fail(f"phase 25: {e}")
    subs = {sub: {k: sum(r["launches"][sub][k] for r in res)
                  for k in res[0]["launches"][sub]}
            for sub in res[0]["launches"]}
    got = {k: sum(c[k] for c in subs.values()) for k in subs["25e"]}
    print(f"[25] launches of the four ranks in the distributed runs, by "
          f"sub-phase (the rank-0 baselines and oracles not counted) "
          f"{subs}; in all {got}")
    for k in ("flash_attention", "flash_attention_bwd", "rmsnorm",
              "rmsnorm_bwd"):
        check(subs["25e"][k] > 0, f"phase 25: GPipe never launched {k}")
        check(subs["25k"][k] > 0, f"phase 25: 25k's tensor-parallel step "
                                  f"never launched {k}")
    check(subs["25l"]["linear_recurrence"] > 0,
          "phase 25: 25l never launched linear_recurrence")
    for k in ("ssd_chunk_scan", "ssd_chunk_scan_bwd", "rmsnorm_cut",
              "rmsnorm_cut_bwd"):
        check(subs["25m"][k] > 0, f"phase 25: 25m never launched {k}")
    for k in ("flash_attention", "flash_attention_bwd", "rmsnorm",
              "rmsnorm_bwd"):
        check(subs["25n"][k] > 0, f"phase 25: 25n never launched {k}")
    print(f"[25] rank 0's numbers {json.dumps(res[0]['rows'])}")
    print(f"[25] phase 25 took {time.perf_counter() - t:.1f} s")
    return got


# -- phase 26: the dry run and its roofline ----------------------------------
#: Phase 26a's trace of phase 18's step on a 1 x 1 mesh (a world of one
#: fake rank), in a process of its own: prints one JSON line.
DRYRUN_18 = """
import json, sys, time
import torch
from repro_torch import models as M
from repro_torch.configs import get_config
from repro_torch.distributed.ctx import axis_rules
from repro_torch.launch import dryrun as D, roofline as R
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.config import ShapeConfig
from repro_torch.train import state_spec
batch, seq = int(sys.argv[1]), int(sys.argv[2])
cfg = get_config("tinyllama-1.1b", kernel_impl="torch")
shape = ShapeConfig("phase18", "train", seq, batch)
args = D.parser().parse_args(["--arch", "tinyllama-1.1b", "--shape", "-",
                              "--microbatches", "1"])
with D.fake_world(1):
    mesh = make_mesh((1, 1), ("data", "model"))
    with axis_rules(mesh, D._rules_for(mesh, args)):
        trace, info = D.lower_cell(cfg, shape, mesh, args)
res = {"arch": "tinyllama-1.1b", "shape": "phase18", "mesh": "single",
       "mesh_shape": dict(mesh.shape), "status": "ok",
       "model_flops": M.model_flops(cfg, shape.tokens, "train"),
       "full": {**D.analyze(trace), **info}}
res["row"] = R.roofline_row(res)
st = state_spec(cfg)
res["leaves"] = {}
for name, tree in (("params", st.params), ("m", st.opt["m"]),
                   ("v", st.opt["v"])):
    def walk(t, pre):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], f"{pre}/{k}")
            else:
                res["leaves"][f"{pre}/{k}"] = t[k].nbytes
    walk(tree, name)
res["step_bytes"] = st.step.nbytes
res["cuda_allocated"] = (torch.cuda.memory_allocated()
                         if torch.cuda.is_initialized() else 0)
print("JSON" + json.dumps(res))
"""
#: Phase 26c's backward collectives: qwen2-moe-a2.7b's presets (the
#: expert-parallel MoE) at two layers, remat full layer by layer, its
#: train_4k step and that step's forward (a prefill of the same batch) on
#: the production (16, 16) mesh, each traced on the fake tensors' device
#: and again on the CPU's; then qwen3-4b's train_4k step with ring
#: attention (``--ring``) at ``RING_26C_LAYERS`` layers on the fake
#: tensors' device only; prints one JSON line.
DRYRUN_BWD = """
import dataclasses, json, math, sys
from repro_torch.configs import get_config, get_optimized_config
from repro_torch.distributed.ctx import axis_rules
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models.config import SHAPES_BY_NAME
cfg = dataclasses.replace(
    get_optimized_config("qwen2-moe-a2.7b", kernel_impl="torch"),
    num_layers=2, remat="full", remat_block=1)
args = D.parser().parse_args(["--arch", cfg.name, "--shape", "train_4k",
                              "--microbatches", "1"])
ring = dataclasses.replace(
    get_config("qwen3-4b", kernel_impl="torch", ring_attention=True),
    num_layers=int(sys.argv[1]))
train = SHAPES_BY_NAME["train_4k"]
res = {"devices": [D.TRACE_DEVICE, "cpu"], "layers": cfg.num_layers}
with D.fake_world(math.prod(production_shape()[0])):
    mesh = make_production_mesh()
    res["mesh_shape"] = dict(mesh.shape)
    with axis_rules(mesh, D._rules_for(mesh, args)):
        for dev in res["devices"]:
            for kind in ("train", "prefill"):
                trace, info = D.lower_cell(
                    cfg, dataclasses.replace(train, kind=kind), mesh, args,
                    device=dev)
                a = D.analyze(trace)
                res[f"{dev}/{kind}"] = {
                    "by_site": a["collectives_by_site"],
                    "trace_device": a["trace_device"],
                    "trace_s": info["trace_s"]}
        trace, info = D.lower_cell(ring, train, mesh, args)
        res["ring"] = {**D.analyze(trace), "trace_s": info["trace_s"]}
print("JSON" + json.dumps(res))
"""
#: Phase 26c: qwen3-4b's ring train_4k trace, cut to 2 of its 36 layers
RING_26C_LAYERS = 2
#: Phase 26b's production cells: (CLI arguments, the roofline's --mesh).
#: The train cell traces its 256 x 4,096 batch as one microbatch where the
#: reference's cell takes 8 (tagged mb1): the trace costs host time by
#: the op, and 8 microbatches took 138 s on the card's host with the other
#: cells beside it.  The products are the same; the temp bytes are a
#: one-microbatch step's.
DRYRUN_CELLS = (
    (["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--mesh", "single",
      "--mode", "both", "--microbatches", "1", "--tag", "mb1"], "single"),
    (["--arch", "qwen2-moe-a2.7b", "--shape", "decode_32k", "--mesh",
      "single", "--mode", "both", "--optimized"], "single"),
    (["--arch", "tinyllama-1.1b", "--shape", "decode_32k", "--mesh", "multi",
      "--mode", "full"], "multi"),
    (["--arch", "mamba2-370m", "--shape", "train_4k", "--mesh", "single",
      "--mode", "full", "--microbatches", "1", "--tag", "mb1"], "single"),
    (["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--mesh", "single",
      "--mode", "full", "--sp", "--microbatches", "1", "--tag", "sp.mb1"],
     "single"),
)
DRYRUN_TIMEOUT = 600
#: Phase 26b: tinyllama-1.1b train_4k on (16, 16).  A rank holds its
#: blocks of params (22,616,576 B) and of m and v (45,233,152 B), the
#: 4-byte step and its 16 of the batch's 256 rows (256 x 4,096 int32 /
#: 16, 262,144 B): a device's share under the shardings, XLA's
#: argument_bytes (PR 31's rank held the global batch, 72,044,036 B)
TRAIN_4K_HELD = 68_111_876
TRAIN_4K_SHARDED = 68_111_876
#: Phase 26b: a rank of train_4k on (16, 16) traces the products of its
#: 16 of the 256 rows (4,096 tokens each) and of its blocks of the heads,
#: MLP columns and vocabulary (``tensor_parallel.train_flops``; k and v
#: whole), exactly: an integer sum
TRAIN_4K_ROWS = (16, 4096)
#: Phase 26b: qwen2-moe-a2.7b decode_32k's (presets) "state" gathers a
#: decode step on (16, 16), (count, result bytes), when the expert leaves
#: were gathered whole over "model" (the dry run's trace of that layout
#: on the CPU)
MOE_DECODE_STATE_WHOLE = (387, 57_703_145_472)
#: Phase 26b: PR 31's temp bytes of the train_4k cell, a rank computing
#: the global step (NVIDIA H100 80GB HBM3's host, PR 31's chip call 1)
TRAIN_4K_TEMP_PR31 = 1_974_505_937_424
#: Phase 26b: mamba2-370m train_4k on (16, 16) computes its 2 of the 32
#: heads; the tied 50,280-row head stays whole (16 does not divide it).
#: Its flops a rank are held at least this many times fewer than its
#: rows' with every weight whole, as the parent traced them
MAMBA_TRAIN4K_CUT = 4.0


#: Phase 26b's cells whose trace is long, started before phase 25 and
#: collected by phase 26: mamba2-370m's plain SSD scan loops over its 32
#: chunks a layer, ~4-5 s of trace a layer on one host core (214-261 s
#: for its 48 layers on an H100 machine's host, PERF.md)
DRYRUN_EARLY = ("mamba2-370m",)
_EARLY = {}


def _dryrun_env():
    """``(out, env)`` of phase 26's subprocesses: the reports' directory
    and an environment without the test hooks (production meshes), one
    thread a process (a fake trace computes nothing)."""
    out = os.path.join(ROOT, "build", "dryrun_torch")
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_MESH_SHAPE", "REPRO_MESH_SHAPE_MULTI",
                        "REPRO_DRYRUN_DEVICES")}
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return out, env


def _dryrun_cell(argv, out, env, logs=None):
    """A dry-run CLI cell's process; ``logs``: its stdout and stderr go to
    these files (a process left running a long time fills no pipe)."""
    so, se = logs if logs else (subprocess.PIPE, subprocess.PIPE)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out",
         out], stdout=so, stderr=se, text=True, env=env, cwd=ROOT)


def _stop_early() -> None:
    for p in _EARLY.values():
        if isinstance(p, subprocess.Popen) and p.poll() is None:
            p.kill()
            p.wait()


def start_early_dryruns() -> None:
    """Start the ``DRYRUN_EARLY`` cells of phase 26b in the background
    (into an emptied ``build/dryrun_torch``, their output to files there);
    :func:`run_dryruns` collects them, and the script's exit kills any
    still running."""
    out, env = _dryrun_env()
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    _EARLY["t"] = time.perf_counter()
    for i, (argv, _) in enumerate(DRYRUN_CELLS):
        if argv[1] in DRYRUN_EARLY:
            logs = tuple(open(os.path.join(out, f"early{i}.{k}"), "w")
                         for k in ("out", "err"))
            _EARLY[i] = _dryrun_cell(argv, out, env, logs)
            for f in logs:
                f.close()
    if not _EARLY.get("registered"):
        atexit.register(_stop_early)
        _EARLY["registered"] = True


def run_dryruns(batch: int, seq: int) -> dict:
    """Phase 26's subprocesses, all started at once (but those of
    ``DRYRUN_EARLY``, started by :func:`start_early_dryruns`, here if it
    was not called): 26a's trace of a ``batch`` x ``seq`` tinyllama-1.1b
    step on a 1 x 1 mesh, 26c's, and 26b's CLI cells (production meshes:
    the test hooks are cleared) into ``build/dryrun_torch``, then the
    roofline CLI over them.  Fails on any non-zero exit."""
    if "t" not in _EARLY:
        start_early_dryruns()
    out, env = _dryrun_env()
    t = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *argv], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for script, argv in ((DRYRUN_18, [str(batch), str(seq)]),
                             (DRYRUN_BWD, [str(RING_26C_LAYERS)]))]
    procs += [_EARLY[i] if i in _EARLY else _dryrun_cell(argv, out, env)
              for i, (argv, _) in enumerate(DRYRUN_CELLS)]
    early_s = t - _EARLY["t"]
    texts = []
    for i, p in enumerate(procs):
        try:
            so, se = p.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            fail(f"phase 26: a dry run ran past {DRYRUN_TIMEOUT} s")
        if so is None:          # an early cell: its output is in files
            so, se = (open(os.path.join(out, f"early{i - 2}.{k}")).read()
                      for k in ("out", "err"))
        check(p.returncode == 0, f"phase 26: {p.args[1:]} exited "
                                 f"{p.returncode}: {se[-3000:]}")
        texts.append(so)
    wall = time.perf_counter() - t
    got = []
    for name, text in (("26a", texts[0]), ("26c", texts[1])):
        line = [x for x in text.splitlines() if x.startswith("JSON")]
        check(len(line) == 1, f"phase {name} printed no result: "
                              f"{text[-2000:]}")
        got.append(json.loads(line[0][4:]))
    cells = []
    for argv, _ in DRYRUN_CELLS:
        arch, shape, mesh = argv[1], argv[3], argv[5]
        tag = f".{argv[argv.index('--tag') + 1]}" if "--tag" in argv else ""
        with open(os.path.join(out, f"{arch}_{shape}_{mesh}{tag}.json")) as f:
            cells.append(json.load(f))
    rows = {}
    for mesh in ("single", "multi"):
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.roofline", "--in",
             out, "--mesh", mesh, "--csv",
             os.path.join(out, f"roofline_{mesh}.csv")],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
        check(r.returncode == 0, f"phase 26: the roofline CLI exited "
                                 f"{r.returncode}: {r.stderr[-2000:]}")
        rows[mesh] = r.stdout.strip().splitlines()
    for k in [k for k in _EARLY if k != "registered"]:
        del _EARLY[k]
    return {"a": got[0], "c": got[1], "cells": cells, "rows": rows,
            "cli": [t.strip().splitlines()[-1] for t in texts[2:]],
            "wall_s": wall, "early_s": early_s}


def phase26c(card: str, c: dict) -> None:
    """Phase 26c: the backward's collectives are recorded on the fake
    tensors' device as on the CPU (the autograd engine runs a CUDA
    tensor's backward on a thread of its own), and they are what the
    forward implies: each layer's forward runs twice (step, recompute) and
    its backward reverses each all-to-all and psum once more, so the body
    holds three times the forward's; the boundary's all-reduces (a cut's
    cotangent) exist only in the backward.  Then the ring's train_4k
    trace against :func:`ring26c_arithmetic`."""
    first, cpu = c["devices"]
    check(first == "cuda", f"phase 26c: the dry run traces on {first!r} "
                           f"fake tensors on the card's host")
    for kind in ("train", "prefill"):
        for dev in (first, cpu):
            got = c[f"{dev}/{kind}"]["trace_device"]
            check(got == dev, f"phase 26c: {kind} traced on {dev} is "
                              f"labelled {got}")
        check(c[f"{first}/{kind}"]["by_site"] == c[f"cpu/{kind}"]["by_site"],
              f"phase 26c: {kind}'s collectives on {first} fake tensors "
              f"{c[f'{first}/{kind}']['by_site']} differ from the CPU's "
              f"{c[f'cpu/{kind}']['by_site']}")
    tb = c[f"{first}/train"]["by_site"]["body"]
    fb = c[f"{first}/prefill"]["by_site"]["body"]
    check(fb["count"]["all-to-all"] == 2 * c["layers"],
          f"phase 26c: the forward's all-to-alls {fb['count']}")
    for key in ("count", "result_bytes"):
        check(tb[key] == {k: 3 * v for k, v in fb[key].items()},
              f"phase 26c: the train step's body {key} {tb[key]} is not "
              f"3 x the forward's {fb[key]}")
    te = c[f"{first}/train"]["by_site"]["boundary"]
    fe = c[f"{first}/prefill"]["by_site"]["boundary"]
    check(fe["count"]["all-reduce"] == 0 < te["count"]["all-reduce"],
          f"phase 26c: boundary all-reduces train {te['count']} forward "
          f"{fe['count']}")
    r = c["ring"]
    ar = ring26c_arithmetic(c["mesh_shape"])
    by = r["collectives_by_site"]
    got = {site: (sum(by[site]["count"].values()),
                  int(sum(by[site]["result_bytes"].values())))
           for site in ("state", "tp")}
    check(r["trace_device"] == first and r["flops"] == ar["flops"],
          f"phase 26c: the ring's train_4k traces {r['flops']:.6e} flops a "
          f"rank on {r['trace_device']}, train_flops {ar['flops']:.6e}")
    for site, want in (("state", ar["state"]), ("tp", ar["tp"])):
        check(got[site] == tuple(want),
              f"phase 26c: the ring's {site} collectives {got[site]}, the "
              f"arithmetic {want}")
    check(by["boundary"]["count"]["all-gather"] == 0,
          f"phase 26c: the ring's step gathers at the boundary "
          f"{by['boundary']['count']}")
    print(f"[26c] ({card}) qwen3-4b with ring attention, "
          f"{RING_26C_LAYERS} layers, train_4k on {c['mesh_shape']} "
          f"({first} fake tensors, trace {r['trace_s']:.2f} s): a rank "
          f"computes {ar['names']} on 1/{ar['n']} blocks; flops a rank "
          f"{r['flops']:.6e} = train_flops (held); state gathers "
          f"{got['state']} (count, result bytes, the norm's all-reduce "
          f"among them) = forward_gathers (held); tp {got['tp']} = "
          f"step_collectives, the ring's head exchanges "
          f"{by['tp']['count']['all-to-all']} all-to-alls among them "
          f"(held); boundary {by['boundary']['count']}: no all-gather "
          f"(held); body {by['body']['count']}")
    print(f"[26c] ({card}) qwen2-moe-a2.7b presets, {c['layers']} layers, "
          f"train_4k on {c['mesh_shape']}: body collectives of the step "
          f"{tb['count']} ({sum(tb['result_bytes'].values()):,.0f} result "
          f"bytes) = 3 x the forward's {fb['count']}; boundary of the step "
          f"{te['count']} ({sum(te['result_bytes'].values()):,.0f} B), of "
          f"the forward {fe['count']}; equal on {first} and cpu fake "
          f"tensors (traces {first} "
          f"{c[f'{first}/train']['trace_s']:.2f} + "
          f"{c[f'{first}/prefill']['trace_s']:.2f} s, cpu "
          f"{c['cpu/train']['trace_s']:.2f} + "
          f"{c['cpu/prefill']['trace_s']:.2f} s)")


def train4k_arithmetic(cell: dict, argv: list) -> dict:
    """What one train_4k step (one microbatch of ``TRAIN_4K_ROWS`` a
    rank) of the cell that ``argv`` traced takes on ``cell``'s mesh, by
    the helpers: ``"sums"`` the
    gradient sums' (count, result bytes) from ``rank_local.backward_sums``
    (a layer's reads once, the rest's, the leaves that gather nothing);
    ``"flops"`` the products a rank traces and ``"flops_whole"`` those of
    the same rows with every weight whole
    (``tensor_parallel.train_flops``); ``"tp"`` the (count, result bytes)
    of ``tensor_parallel.step_collectives``."""
    from repro_torch.distributed import rank_local
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.mesh import AbstractMesh
    from repro_torch.launch import dryrun as D
    args = D.parser().parse_args(argv)
    cfg = D.cell_config(cell["arch"], args)
    mesh = AbstractMesh(tuple(cell["mesh_shape"].values()),
                        tuple(cell["mesh_shape"]))
    rules = D._rules_for(mesh, args)
    layout = rank_local.layout_for(cfg, mesh, rules)
    n = rank_local.backward_sums(cfg, layout, D.data_axes(mesh))
    names = tpar.local_names(cfg, mesh, rules)
    tp = layout.model_cut()
    rows, seq = TRAIN_4K_ROWS
    return {"sums": (cfg.num_layers * n["unit"][0] + n["rest"][0]
                     + n["whole"][0],
                     cfg.num_layers * n["unit"][1] + n["rest"][1]
                     + n["whole"][1]),
            "flops": tpar.train_flops(cfg, names, tp.n, rows, seq),
            "flops_whole": tpar.train_flops(cfg, frozenset(), 1, rows, seq),
            "tp": tpar.step_collectives(cfg, names, tp.n, rows, seq),
            "n": tp.n}


def ring26c_arithmetic(mesh_shape: dict) -> dict:
    """What 26c's qwen3-4b ring train_4k step (one microbatch of
    ``TRAIN_4K_ROWS`` a rank, ``RING_26C_LAYERS`` layers) takes on a rank
    of ``mesh_shape``, by the helpers: ``"flops"``
    (``tensor_parallel.train_flops`` of its rows and heads: the ring's
    blocks on every head of its sequence block), ``"state"``
    (``rank_local.step_gathers``: the gathers and the norm's 4-byte
    all-reduce) and ``"tp"`` (``step_collectives``: the
    ring's exchanges of heads for sequence blocks among them)."""
    from repro_torch.configs import get_config
    from repro_torch.distributed import rank_local
    from repro_torch.distributed import tensor_parallel as tpar
    from repro_torch.distributed.mesh import AbstractMesh
    from repro_torch.launch import dryrun as D
    cfg = dataclasses.replace(
        get_config("qwen3-4b", kernel_impl="torch", ring_attention=True),
        num_layers=RING_26C_LAYERS)
    mesh = AbstractMesh(tuple(mesh_shape.values()), tuple(mesh_shape))
    args = D.parser().parse_args(["--arch", cfg.name, "--shape", "-"])
    rules = D._rules_for(mesh, args)
    layout = rank_local.layout_for(cfg, mesh, rules)
    names = tpar.local_names(cfg, mesh, rules)
    tp = layout.model_cut()
    rows, seq = TRAIN_4K_ROWS
    return {"flops": tpar.train_flops(cfg, names, tp.n, rows, seq),
            "state": rank_local.step_gathers(cfg, layout),
            "tp": tpar.step_collectives(cfg, names, tp.n, rows, seq),
            "names": sorted(names), "n": tp.n}


def moe_decode_arithmetic(cell: dict) -> tuple:
    """26b's qwen2-moe-a2.7b decode_32k cell (``--optimized``): the
    ``"state"`` gathers (count, result bytes) of one decode step on a
    rank, each layer's leaves read once and the rest's
    (``rank_local.forward_gathers`` under the cell's rules)."""
    import argparse
    from repro_torch.configs import step_settings
    from repro_torch.distributed import rank_local
    from repro_torch.distributed.mesh import AbstractMesh
    from repro_torch.launch import dryrun as D
    args = D.parser().parse_args(["--arch", cell["arch"], "--shape",
                                  cell["shape"], "--optimized"])
    args = argparse.Namespace(**{**vars(args),
                                 **step_settings(cell["arch"])})
    cfg = D.cell_config(cell["arch"], args)
    mesh = AbstractMesh(tuple(cell["mesh_shape"].values()),
                        tuple(cell["mesh_shape"]))
    layout = rank_local.layout_for(cfg, mesh, D._rules_for(mesh, args))
    g = rank_local.forward_gathers(cfg, layout)
    return (cfg.num_layers * g["unit"][0] + g["rest"][0],
            cfg.num_layers * g["unit"][1] + g["rest"][1])


def phase26(card: str, p18: dict) -> dict:
    """Phase 26: the dry run of phase 18's step held against phase 18's
    measurements (``p18``: the state's leaf bytes by path, the batch's
    bytes, the step's ms and the peak bytes), then the production cells
    and the roofline."""
    from repro_torch.launch import roofline
    t = time.perf_counter()
    got = run_dryruns(p18["batch"], p18["seq"])
    a = got["a"]
    mem, row = a["full"]["memory"], a["row"]
    # 26a: the argument bytes are phase 18's state on the card, leaf for
    # leaf, plus the batch and the step counter (a 0-d int32 in the
    # spec, a Python int in the port's TrainState)
    check(a["leaves"] == p18["leaves"],
          "phase 26a: the dry run's state leaves differ from phase 18's: "
          + str(sorted(set(a["leaves"].items())
                       ^ set(p18["leaves"].items()))[:6]))
    state = sum(p18["leaves"].values())
    want = state + p18["batch_bytes"] + a["step_bytes"]
    check(mem["argument_bytes"] == want,
          f"phase 26a: argument_bytes {mem['argument_bytes']}, phase 18's "
          f"state {state} + batch {p18['batch_bytes']} + step "
          f"{a['step_bytes']} = {want}")
    check(mem["sharded_argument_bytes"] == mem["argument_bytes"],
          f"phase 26a: on a 1 x 1 mesh the sharded argument bytes "
          f"{mem['sharded_argument_bytes']} differ from "
          f"{mem['argument_bytes']}")
    check(a["cuda_allocated"] == 0,
          f"phase 26a: the trace allocated {a['cuda_allocated']} bytes")
    step_s = p18["step_ms"] / 1e3
    check(row["t_compute_s"] <= step_s,
          f"phase 26a: the compute term {row['t_compute_s']:.4f} s exceeds "
          f"phase 18's measured step {step_s:.4f} s")
    peak = mem["argument_bytes"] + mem["temp_bytes"]
    print(f"[26a] ({card}) phase 18's step traced on a 1 x 1 fake world "
          f"({a['full']['trace_device']} fake tensors, "
          f"{a['full']['trace_s']:.2f} s): argument_bytes "
          f"{mem['argument_bytes']:,} = phase 18's state on the card "
          f"{state:,} ({len(p18['leaves'])} leaves, params + m + v, equal "
          f"leaf for leaf) + batch {p18['batch_bytes']:,} + step "
          f"{a['step_bytes']}; sharded_argument_bytes "
          f"{mem['sharded_argument_bytes']:,}; flops "
          f"{a['full']['flops']:.4e}, bytes accessed "
          f"{a['full']['bytes_accessed']:.4e}")
    print(f"[26a] ({card}) roofline at {roofline.PEAK_FLOPS:.4g} FLOP/s, "
          f"{roofline.HBM_BW:.4g} B/s: t_compute_s {row['t_compute_s']:.6f}"
          f" <= phase 18's step {step_s:.6f} s (held); t_memory_s "
          f"{row['t_memory_s']:.6f} (the plain attention writes the S^2 "
          f"scores the kernel never writes, so this term may exceed the "
          f"step); dominant {row['dominant']}; useful_flop_ratio "
          f"{row['useful_flop_ratio']:.4f}; compute share of the measured "
          f"step {row['t_compute_s'] / step_s:.4f}; traced peak "
          f"(argument + temp) {peak / 1e9:.3f} GB against phase 18's "
          f"max_memory_allocated {p18['peak_bytes'] / 1e9:.3f} GB "
          f"(temp {mem['temp_bytes'] / 1e9:.3f} GB)")
    plain4k = [cell for (argv, _), cell in zip(DRYRUN_CELLS, got["cells"])
               if cell["arch"] == "tinyllama-1.1b"
               and cell["shape"] == "train_4k" and "--sp" not in argv][0]
    for (argv, _), cell, cli in zip(DRYRUN_CELLS, got["cells"], got["cli"]):
        check(cell["status"] == "ok", f"phase 26b: {cell['arch']} "
                                      f"{cell['shape']} {cell['mesh']}: "
                                      f"{cell.get('error')}")
        m = cell["full"]["memory"]
        check(m["argument_bytes"] == m["sharded_argument_bytes"],
              f"phase 26b: {cell['arch']} {cell['shape']} holds "
              f"{m['argument_bytes']:,} B a rank, a device's share under "
              f"the shardings {m['sharded_argument_bytes']:,}")
        if cell["shape"] == "train_4k":
            tiny = cell["arch"] == "tinyllama-1.1b"
            check(not tiny or (m["argument_bytes"] == TRAIN_4K_HELD
                               and m["sharded_argument_bytes"]
                               == TRAIN_4K_SHARDED),
                  f"phase 26b: {cell['arch']} train_4k argument_bytes "
                  f"{m['argument_bytes']:,} (want {TRAIN_4K_HELD:,}), "
                  f"sharded {m['sharded_argument_bytes']:,} (want "
                  f"{TRAIN_4K_SHARDED:,})")
            ar = train4k_arithmetic(cell, argv)
            flops = cell["full"]["flops"]
            check(flops == ar["flops"],
                  f"phase 26b: train_4k traces {flops:.6e} flops a rank, "
                  f"the TP arithmetic {ar['flops']:.6e}")
            sums = ar["sums"]
            grad = cell["full"]["collectives_by_site"]["grad"]
            check((sum(grad["count"].values()),
                   sum(grad["result_bytes"].values())) == sums,
                  f"phase 26b: train_4k's gradient sums {grad['count']} of "
                  f"{sum(grad['result_bytes'].values()):,.0f} B, the "
                  f"arithmetic {sums}")
            tps = cell["full"]["collectives_by_site"]["tp"]
            got_tp = (sum(tps["count"].values()),
                      int(sum(tps["result_bytes"].values())))
            check(got_tp == tuple(ar["tp"]),
                  f"phase 26b: train_4k's tp collectives {got_tp}, the "
                  f"arithmetic {ar['tp']}")
        if cell["shape"] == "train_4k" and not tiny:
            cut = ar["flops_whole"] / flops
            check(cut >= MAMBA_TRAIN4K_CUT,
                  f"phase 26b: {cell['arch']} train_4k traces {flops:.6e} "
                  f"flops a rank, only {cut:.2f}x fewer than with every "
                  f"weight whole (want >= {MAMBA_TRAIN4K_CUT})")
            print(f"[26b] ({card}) {cell['arch']} train_4k on "
                  f"{cell['mesh_shape']} (one microbatch): a rank holds "
                  f"{m['argument_bytes']:,} B (a device's share under the "
                  f"shardings, held); flops a rank {flops:.6e} = the "
                  f"arithmetic of its rows and its {ar['n']}-way cut of the "
                  f"heads (held; the tied vocabulary whole), {cut:.2f}x "
                  f"fewer than its rows with every weight whole "
                  f"{ar['flops_whole']:.6e}, the parent's trace (held >= "
                  f"{MAMBA_TRAIN4K_CUT}); tp collectives {got_tp} = "
                  f"step_collectives (held); gradient sums {grad['count']} "
                  f"= backward_sums (held); temp {m['temp_bytes']:,} B")
        elif cell["shape"] == "train_4k" and "--sp" in argv:
            pm = plain4k["full"]["memory"]
            check(flops == plain4k["full"]["flops"]
                  and m["temp_bytes"] < pm["temp_bytes"],
                  f"phase 26b: train_4k --sp traces {flops:.6e} flops and "
                  f"{m['temp_bytes']:,} temp bytes a rank; without --sp "
                  f"{plain4k['full']['flops']:.6e} and "
                  f"{pm['temp_bytes']:,}")
            print(f"[26b] ({card}) {cell['arch']} train_4k --sp on "
                  f"{cell['mesh_shape']} (one microbatch): flops a rank "
                  f"{flops:.6e}, equal to the cell without --sp (held: "
                  f"sequence parallelism moves no product) and to the "
                  f"arithmetic (held); temp {m['temp_bytes']:,} B against "
                  f"{pm['temp_bytes']:,} without --sp "
                  f"({pm['temp_bytes'] / m['temp_bytes']:.2f}x less, held "
                  f"below); tp collectives {got_tp} = step_collectives with "
                  f"the sequence's all-gathers and reduce-scatters (held; "
                  f"by kind {tps['count']}); gradient sums "
                  f"{grad['count']} = backward_sums (held)")
        elif cell["shape"] == "train_4k":
            print(f"[26b] ({card}) {cell['arch']} train_4k on "
                  f"{cell['mesh_shape']}: a rank holds {m['argument_bytes']:,}"
                  f" B = its blocks of params, m and v 67,849,728 + the step "
                  f"4 + its 16 of the 256 x 4,096 int32 rows 262,144 (held), "
                  f"{m['argument_bytes'] / m['sharded_argument_bytes']:.4f}x "
                  f"a device's share under the shardings "
                  f"{m['sharded_argument_bytes']:,} (1.0577x when every rank "
                  f"held the global batch, PR 31); flops a rank "
                  f"{flops:.6e} = the TP arithmetic of its rows and its "
                  f"1/{ar['n']} of the heads, MLP columns and vocabulary "
                  f"(held; {ar['flops_whole'] / flops:.2f}x less than its "
                  f"rows with every weight whole, {ar['flops_whole']:.6e}); "
                  f"tp collectives {got_tp} (count, result bytes) = "
                  f"step_collectives (held); temp {m['temp_bytes']:,} B "
                  f"against "
                  f"PR 31's {TRAIN_4K_TEMP_PR31:,} "
                  f"({TRAIN_4K_TEMP_PR31 / m['temp_bytes']:.2f}x less); "
                  f"gradient sums over data {grad['count']} of "
                  f"{sum(grad['result_bytes'].values()):,.0f} B, "
                  f"rank_local.backward_sums' arithmetic (held)")
        if cell["arch"] == "qwen2-moe-a2.7b":
            st = cell["full"]["collectives_by_site"]["state"]
            got_st = (sum(st["count"].values()),
                      int(sum(st["result_bytes"].values())))
            want_st = moe_decode_arithmetic(cell)
            check(got_st == want_st,
                  f"phase 26b: {cell['arch']} {cell['shape']}'s state "
                  f"gathers {got_st}, the arithmetic {want_st}")
            print(f"[26b] ({card}) {cell['arch']} {cell['shape']} "
                  f"(presets, expert parallelism on a rank's experts): a "
                  f"decode step gathers {got_st[0]} leaves of "
                  f"{got_st[1]:,} B = rank_local.forward_gathers (held), "
                  f"{MOE_DECODE_STATE_WHOLE[1] / got_st[1]:.2f}x less "
                  f"than with the experts gathered whole over model "
                  f"({MOE_DECODE_STATE_WHOLE[0]} of "
                  f"{MOE_DECODE_STATE_WHOLE[1]:,} B)")
        r = roofline.roofline_row(cell)
        print(f"[26b] ({card}) {cell['arch']} {cell['shape']} "
              f"{cell['mesh']} {cell['mesh_shape']}: {cell['status']}, "
              f"trace {cell['full']['trace_s']:.2f} s, argument_bytes "
              f"{m['argument_bytes']:,} (held by a rank) against "
              f"sharded_argument_bytes {m['sharded_argument_bytes']:,} (a "
              f"device's under the shardings), temp {m['temp_bytes']:,}; "
              f"collectives {cell['full']['collectives']['count']}; "
              f"roofline ({r['source']}): compute {r['t_compute_s']:.4e} s, "
              f"memory {r['t_memory_s']:.4e} s, collective "
              f"{r['t_collective_s']:.4e} s, {r['dominant']}, useful "
              f"{r['useful_flop_ratio']:.4e}")
        print(f"[26b] ({card}) {cli}")
        if "--tag" in argv:
            print(f"[26b] ({card}) {cell['arch']} {cell['shape']} is tagged "
                  f"{argv[argv.index('--tag') + 1]}: traced as "
                  f"{argv[argv.index('--microbatches') + 1]} microbatch, "
                  f"not the reference's 8, so its temp bytes and the "
                  f"roofline's mem_gib_per_dev are that step's")
    for mesh, lines in got["rows"].items():
        # one row an (arch, shape): the --sp cell shares its row
        check(len(lines) == 1 + len({(a[1], a[3]) for a, m in DRYRUN_CELLS
                                     if m == mesh}),
              f"phase 26b: the roofline CLI's {mesh} rows: {lines}")
        for line in lines:
            print(f"[26b] ({card}) roofline --mesh {mesh}: {line}")
    phase26c(card, got["c"])
    wall = time.perf_counter() - t
    print(f"[26] ({card}) phase 26 took {wall:.1f} s (subprocesses "
          f"{got['wall_s']:.1f} s; {', '.join(DRYRUN_EARLY)} started "
          f"{got['early_s']:.1f} s before them)")
    return {"row": row, "memory": mem, "wall_s": wall}


# -- phase 27: the examples and scripts, run as users run them ---------------
#: Phase 27's runs, all started at once, each ``python3 <file> [args]`` in
#: a process of its own from the root of the checkout: (name, argv, a
#: pattern the last line of its output must match).  The ZNS files also
#: run on the CPU, to be held against the card's numbers.
EXAMPLES27 = (
    ("zns_checkpointing", ["examples/zns_checkpointing_torch.py"],
     r"^  -> training-data reads next to checkpoint writes need ZNS-class "
     r"isolation$"),
    ("zns_checkpointing_cpu",
     ["examples/zns_checkpointing_torch.py", "--device", "cpu"],
     r"^  -> training-data reads .* isolation$"),
    ("zns_hillclimb", ["scripts/zns_hillclimb_torch.py"],
     r"^naive -> best: [\d.]+s -> [\d.]+s \([\d.]+x\)$"),
    ("zns_hillclimb_cpu", ["scripts/zns_hillclimb_torch.py", "--device",
                           "cpu"],
     r"^naive -> best: [\d.]+s -> [\d.]+s \([\d.]+x\)$"),
    ("failover_demo", ["examples/failover_demo_torch.py"],
     r"^failover demo complete$"),
    ("quickstart", ["examples/quickstart_torch.py"], r"^ \[[\d ]+\]\]$"),
    ("serve_batch", ["examples/serve_batch_torch.py"],
     r"^  req \d+: \d+ tokens \[[\d, ]+\]\.\.\.$"),
    ("train_small", ["examples/train_small_torch.py", "--full-100m"],
     r"^loss: [\d.]+ -> [\d.]+ \(OK\)$"),
    ("inspect_collectives",
     ["scripts/inspect_collectives_torch.py", "--arch", "tinyllama-1.1b",
      "--shape", "train_4k", "--depth", "2"],
     r"^ +[\d.]+ MiB  [a-z-]+ +site=\w+ group=\d+$"),
    ("make_experiments_tables",
     ["scripts/make_experiments_tables_torch.py", "--in",
      "build/dryrun_torch"],
     r"^\| [\w.-]+ \| \w+ \| .* \|$"),
)
#: Phase 27: the longest a run may take (train_small at --full-100m,
#: 300 steps, is the longest)
EXAMPLES27_TIMEOUT = 400
#: Phase 27: the kernels each run on the card must launch (and how often,
#: where a run's count is fixed: one scan a payload write, one batched
#: scan a store save); the CPU runs, failover_demo, the dry run and the
#: tables launch none
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "rmsnorm",
                 "rmsnorm_bwd")
LAUNCHES27 = {
    "zns_checkpointing": {"zns_event_scan": 4},
    "zns_hillclimb": {"zns_event_scan": 6},
    "quickstart": {k: None for k in TRAIN_KERNELS},
    "serve_batch": {"rmsnorm": None},
    "train_small": {"zns_event_scan_batched": 1,
                    **{k: None for k in TRAIN_KERNELS}},
}
#: Phase 27: the ZNS files' numbers on the card against the CPU's (the
#: float64 scans agree to ~1e-16; see phase 17)
ZNS27_REL = 1e-9
#: Phase 27: quickstart's 20 losses, kernels (``"auto"``) against plain
#: versions (``"xla"``) on the card, bfloat16 activations: the largest
#: relative difference of a step's loss (1.957e-04 read on an NVIDIA H100
#: 80GB HBM3 at 700.00 W)
QS_LOSS_REL = 1e-3
_NUM27 = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _load27(name: str, path: str):
    """An example or script of the checkout as a module (its
    ``__main__`` block does not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quiet(fn, *args, **kw):
    """``fn(*args, **kw)`` with its standard output captured: ``(result,
    text)``."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kw)
    return out, buf.getvalue()


def _rel27(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def phase27(card: str) -> dict:
    """Phase 27: the eight example and script files of the port run as a
    user runs them, each ``python3 <file>`` in a subprocess on the card
    (all at once; each writes its kernels' launches at exit through
    ``REPRO_TORCH_LAUNCH_LOG``), the ZNS files also on the CPU; meanwhile
    quickstart's body in this process on the kernels and on the plain
    versions, and the ZNS files' bodies on the card and on the CPU, their
    numbers unrounded.  Returns ``{"launches", "wall_s"}``: the runs on
    the card, summed by kernel."""
    t = time.perf_counter()
    logdir = os.path.join(ROOT, "build", "phase27")
    shutil.rmtree(logdir, ignore_errors=True)
    os.makedirs(os.path.join(logdir, "tmp"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("REPRO_MESH_SHAPE", "REPRO_MESH_SHAPE_MULTI",
                        "REPRO_DRYRUN_DEVICES")}
    # train_small's checkpoint directory (tempfile.mkdtemp) under build/
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="2",
               TMPDIR=os.path.join(logdir, "tmp"))
    runs = {}
    try:
        for name, argv, _ in EXAMPLES27:
            runs[name] = _start27(name, argv, logdir, env)
        return _check27(card, t, logdir, runs)
    finally:
        # a failed check or an error leaves no run behind on the card
        for r in runs.values():
            if r["proc"].poll() is None:
                r["proc"].kill()
                r["proc"].wait()


def _start27(name: str, argv: list, logdir: str, env: dict) -> dict:
    """Starts ``python3 <argv>`` (phase 27's run ``name``), its output
    and its launch log under ``logdir``; a thread records its end."""
    def waiter(r):
        r["proc"].wait()
        r["end"] = time.perf_counter()

    out = open(os.path.join(logdir, f"{name}.out"), "w")
    err = open(os.path.join(logdir, f"{name}.err"), "w")
    r = dict(start=time.perf_counter(), out=out, err=err,
             proc=subprocess.Popen(
                 [sys.executable, *argv], stdout=out, stderr=err, cwd=ROOT,
                 env=dict(env, REPRO_TORCH_LAUNCH_LOG=os.path.join(
                     logdir, f"{name}.json"))))
    r["thread"] = threading.Thread(target=waiter, args=(r,), daemon=True)
    r["thread"].start()
    return r


def _check27(card: str, t: float, logdir: str, runs: dict) -> dict:
    """Phase 27's holds while and after ``runs`` run: see :func:`phase27`
    (which started ``t`` and the runs)."""
    import numpy as np
    import torch
    from repro_torch import kernels as K
    # meanwhile, in this process: quickstart's body on the kernels and on
    # the plain versions, from the same init and batches
    qs = _load27("quickstart_torch",
                 os.path.join(ROOT, "examples", "quickstart_torch.py"))
    cuda = torch.device("cuda")
    K.reset_launch_counts()
    auto, _ = _quiet(qs.run, qs.config("auto"), device=cuda)
    got = K.launch_counts()
    for k in TRAIN_KERNELS:
        check(got[k] > 0, f"phase 27: quickstart on 'auto' never launched "
                          f"{k}: {got}")
    own = dict(got)
    K.reset_launch_counts()
    plain, _ = _quiet(qs.run, qs.config("xla"), device=cuda)
    check(not any(K.launch_counts().values()),
          f"phase 27: quickstart on 'xla' launched {K.launch_counts()}")
    del auto["state"], plain["state"]
    rel = max(_rel27(a, b) for a, b in zip(auto["losses"], plain["losses"]))
    print(f"[27] ({card}) quickstart in-process, kernels vs plain "
          f"versions: 20 losses {[round(x, 4) for x in auto['losses']]}, "
          f"largest relative difference {rel:.3e} (limit {QS_LOSS_REL}); "
          f"greedy tokens {auto['tokens'].tolist()} and "
          f"{plain['tokens'].tolist()}; launches {own}")
    check(all(np.isfinite(auto["losses"])) and rel <= QS_LOSS_REL,
          f"phase 27: quickstart's losses {auto['losses']} on the kernels, "
          f"{plain['losses']} on the plain versions")
    check(np.array_equal(auto["tokens"], plain["tokens"]),
          f"phase 27: quickstart's greedy tokens {auto['tokens'].tolist()} "
          f"on the kernels, {plain['tokens'].tolist()} on the plain versions")

    # the ZNS files' bodies, unrounded, on the card against the CPU
    zc = _load27("zns_checkpointing_torch",
                 os.path.join(ROOT, "examples", "zns_checkpointing_torch.py"))
    hc = _load27("zns_hillclimb_torch",
                 os.path.join(ROOT, "scripts", "zns_hillclimb_torch.py"))
    K.reset_launch_counts()
    zg, zg_text = _quiet(zc.run, device=cuda)
    hg, hg_text = _quiet(hc.run, device=cuda)
    zns_launches = K.launch_counts()["zns_event_scan"]
    check(zns_launches == 4 + 6, f"phase 27: the ZNS files' bodies launched "
                                 f"the scan {zns_launches} times")
    own["zns_event_scan"] += zns_launches
    zw, zw_text = _quiet(zc.run, device="cpu")
    hw, hw_text = _quiet(hc.run, device="cpu")
    check(zg_text == zw_text and hg_text == hw_text,
          "phase 27: the ZNS files print other text on the card than on "
          "the CPU")
    pairs = [(f"{n} seconds", zg["policies"][n][0], zw["policies"][n][0])
             for n in zg["policies"]]
    pairs += [("gc_s", zg["gc_s"], zw["gc_s"]),
              ("zns write_cv", zg["zns"].write_cv, zw["zns"].write_cv),
              ("zns read p95", zg["zns"].read_lat_p95_us,
               zw["zns"].read_lat_p95_us)]
    pairs += [(f"{n} {k}", hg["rows"][n][k], hw["rows"][n][k])
              for n in hg["rows"] for k in ("host_s", "wall", "med", "bw")]
    worst = max(_rel27(a, b) for _, a, b in pairs)
    check(all(zg["policies"][n][1] == zw["policies"][n][1]
              for n in zg["policies"])
          and all(hg["rows"][n]["req"] == hw["rows"][n]["req"]
                  for n in hg["rows"]),
          "phase 27: appends or requests differ between the card and CPU")
    check(worst <= ZNS27_REL, f"phase 27: the ZNS files' numbers on the "
          f"card against the CPU's: {[(w, a, b) for w, a, b in pairs if _rel27(a, b) > ZNS27_REL]}")
    print(f"[27] ({card}) the ZNS files in-process: {len(pairs)} numbers "
          f"on the card within {worst:.3e} relative of the CPU's (limit "
          f"{ZNS27_REL}), the text equal, {zns_launches} scan launches; "
          f"naive -> best {hg['base']!r} s -> {hg['best']!r} s")

    # the subprocesses
    deadline = time.perf_counter() + EXAMPLES27_TIMEOUT
    for r in runs.values():
        r["thread"].join(timeout=max(deadline - time.perf_counter(), 0.1))
    late = [n for n, r in runs.items() if r["proc"].poll() is None]
    if late:
        for r in runs.values():
            r["proc"].kill()
        fail(f"phase 27: {late} ran past {EXAMPLES27_TIMEOUT} s")
    texts, summed = {}, {k: 0 for k in K.launch_counts()}
    for name, argv, last in EXAMPLES27:
        r = runs[name]
        r["thread"].join()
        r["out"].close()
        r["err"].close()
        with open(os.path.join(logdir, f"{name}.out")) as f:
            text = f.read()
        with open(os.path.join(logdir, f"{name}.err")) as f:
            err = f.read()
        check(r["proc"].returncode == 0,
              f"phase 27: python3 {' '.join(argv)} exited "
              f"{r['proc'].returncode}: {err[-3000:]}")
        lines = text.rstrip("\n").splitlines()
        check(bool(lines) and re.match(last, lines[-1]) is not None,
              f"phase 27: {name}'s last line {lines[-1:]} does not match "
              f"{last!r}")
        log = os.path.join(logdir, f"{name}.json")
        # no log: the run never imported the kernels, so launched none
        got = {k: 0 for k in summed}
        if os.path.exists(log):
            with open(log) as f:
                got = json.load(f)
        want = LAUNCHES27.get(name, {})
        for k, n in got.items():
            if k not in want:
                check(n == 0, f"phase 27: {name} launched {k} {n} times")
            else:
                check(n > 0 if want[k] is None else n == want[k],
                      f"phase 27: {name} launched {k} {n} times, not "
                      f"{want[k] or 'at least once'}")
            if not name.endswith("_cpu"):
                summed[k] += n
        texts[name] = text
        print(f"[27] ({card}) python3 {' '.join(argv)}: exit 0 in "
              f"{r['end'] - r['start']:.1f} s; last line {lines[-1]!r}; "
              f"launches {({k: n for k, n in got.items() if n})}")
    for name in ("zns_checkpointing", "zns_hillclimb"):
        card_nums = [float(x) for x in _NUM27.findall(texts[name])]
        cpu_nums = [float(x) for x in _NUM27.findall(texts[f"{name}_cpu"])]
        check(len(card_nums) == len(cpu_nums) and all(
            _rel27(a, b) <= ZNS27_REL for a, b in zip(card_nums, cpu_nums)),
            f"phase 27: {name}'s printed numbers on the card differ from "
            f"the CPU's")
    for pat in (r"^served 12/12 requests in \d+ decode steps",
                r"^# \d+ collectives, total result bytes/rank",
                r"^### §Roofline"):
        check(any(re.search(pat, t, re.M) for t in texts.values()),
              f"phase 27: no output line matches {pat!r}")
    print("[27] train_small --full-100m:\n" + texts["train_small"].rstrip())
    for k, n in own.items():
        summed[k] += n
    for k in TRAIN_KERNELS + ("zns_event_scan", "zns_event_scan_batched"):
        check(summed[k] > 0, f"phase 27 never launched {k}")
    wall = time.perf_counter() - t
    print(f"[27] ({card}) phase 27 took {wall:.1f} s; launches {summed}")
    return {"launches": summed, "wall_s": wall}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np

    import repro_torch.core as P
    from repro_torch.core import KiB, OpType, exactness
    from repro_torch.core import shard as pshard
    import torch.nn.functional as F

    from repro_torch import kernels as K
    from repro_torch import models as M
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.experiments import ExperimentRunner
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import linear_recurrence as klr
    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import rmsnorm as krms
    from repro_torch.kernels import ssd_chunk_scan as kssd
    from repro_torch.kernels import zns_event_scan as kscan
    from repro_torch.kernels import zns_fixpoint as kfix
    from repro_torch.launch import serve as lserve
    from repro_torch.serve import greedy_generate

    cuda = torch.device("cuda")
    t0 = time.perf_counter()

    # -- phase 1: the card ----------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown"
    print(f"[1] card: {card}")
    print(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    tb = time.perf_counter()
    libs = _build.build()
    print(f"[1] built {sorted(libs)} in {time.perf_counter() - tb:.1f} s")
    ptxas = {}
    for name, path in libs.items():
        log = (path.parent / "build.log").read_text()
        ptxas[name] = ptxas_lines(log)
        for kern, regs, spill in ptxas[name]:
            print(f"[1]   {name}: {kern}: {regs} registers; {spill}")
            if kern.startswith(NO_SPILL):
                check(re.search(r"\b0 bytes spill stores, 0 bytes spill "
                                r"loads", spill) is not None,
                      f"{name}: {kern} spills: {spill}")
        serial = [line for line in log.splitlines() if "C7518" in line]
        check(not serial, f"{name}: ptxas serialised wgmma (C7518): "
                          + " | ".join(serial))

    launches = {k: 0 for k in K.launch_counts()}
    phase_counts = {}

    def read_counts(phase: str, need):
        got = K.launch_counts()
        for k, v in got.items():
            launches[k] += v
        phase_counts[phase] = got
        print(f"[{phase}] launches {got}")
        for k in need:
            check(got[k] > 0, f"phase {phase}: kernel {k} never launched")

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float64, device=cuda)
    rng = np.random.default_rng(0)
    report = {}

    # -- phase 2: kernels vs plain versions on the card ---------------------
    def scan_inputs(shape, dtype):
        issue = np.sort(rng.uniform(0, 1e6, shape), axis=-1)
        svc = rng.uniform(1, 50, shape)
        seg = rng.uniform(size=shape) < 1e-3
        seg[..., 0] = True
        return (torch.as_tensor(issue, dtype=dtype, device=cuda),
                torch.as_tensor(svc, dtype=dtype, device=cuda),
                torch.as_tensor(seg, device=cuda))

    def scan_library(issue, svc, seg):
        """The same scan as PyTorch library calls (the yardstick of the
        scan kernel; the port never calls it): within each segment c_i =
        V_i + max_{j <= i} (s_j - V_{j-1}), V the running sum of svc
        (torch.cumsum), the maximum a torch.cummax over keys lifted by the
        segment's number times the keys' span, so that no segment sees an
        earlier one's keys.  The lift costs float64 digits."""
        v = torch.cumsum(svc, -1)
        y = issue - (v - svc)
        lift = torch.cumsum(seg, -1, dtype=svc.dtype) * (y.max() - y.min()
                                                          + 1.0)
        return v + (torch.cummax(y + lift, -1).values - lift)

    def host_oracle(issue, svc, seg):
        """The sequential float64 loop on the host, row by row."""
        rows = [x.reshape(-1, x.shape[-1]).cpu().numpy()
                for x in (issue, svc, seg)]
        return np.stack([P.zone_sequential_completions(i, s, g,
                                                       backend="python")
                         for i, s, g in zip(*rows)]).reshape(issue.shape)

    for name, shape, op in (
            ("zns_event_scan", (1_600_000,), ops.zns_event_scan),
            ("zns_event_scan", (100_000,), ops.zns_event_scan),
            ("zns_event_scan_batched", (16, 100_000),
             ops.zns_event_scan_batched)):
        for dtype in (torch.float32, torch.float64):
            args = scan_inputs(shape, dtype)
            got = op(*args, impl="cuda")
            want = op(*args, impl="torch")
            torch.cuda.synchronize()
            tol = F64 if dtype == torch.float64 else F32
            err = close(got.cpu().numpy(), want.cpu().numpy(), tol,
                        f"{name} {shape} {dtype}")
            wrapper = kscan.zns_event_scan if op is ops.zns_event_scan \
                else kscan.zns_event_scan_batched
            launch = dict(wrapper.last_launch)
            ms = time_ms(lambda: op(*args, impl="cuda"), flush=flush)
            kms, nk = device_ms(lambda: op(*args, impl="cuda"),
                                "scan_tiles_kernel")
            pms = time_ms(lambda: op(*args, impl="torch"), reps=3,
                          flush=flush)
            lms = time_ms(lambda: scan_library(*args), flush=flush)
            line = (f"[2] {name} {shape} {dtype}: max abs err {err:.3e}, "
                    f"kernel {ms:.4f} ms (device {kms} ms, {nk} device "
                    f"kernel a call; grid {launch['grid']} of "
                    f"{launch['resident_blocks']} resident blocks, "
                    f"{launch['registers']} registers), plain {pms:.4f} "
                    f"ms, library (cumsum + cummax) {lms:.4f} ms")
            if dtype != torch.float64:
                print(line)
                continue
            oracle = host_oracle(*args)
            kerr = close(got.cpu().numpy(), oracle, F64,
                         f"{name} {shape} against the sequential oracle")
            lib_err = float(np.abs(scan_library(*args).cpu().numpy()
                                   - oracle).max())
            print(f"{line}; against the sequential oracle: kernel "
                  f"{kerr:.3e}, library {lib_err:.3e}")
            n = int(np.prod(shape))
            b, by = bound_ms(25.0 * n, 3.0 * n, "float64")
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                       bound_by=by, library_ms=lms, kernel_ms=kms,
                       kernels_per_call=nk, oracle_err=kerr,
                       library_err=lib_err, shape=list(shape),
                       dtype="float64", **launch)
            if name in report:
                report[name]["at_100k"] = row
            else:
                report[name] = row

    def readme_fleet_workload():
        return (P.WorkloadSpec()
                .writes(n=50_000, size=4 * KiB, qd=4)
                .reads(n=50_000, size=4 * KiB, qd=16, zone=100, nzones=64))

    fleet16 = P.DeviceFleet.homogeneous(16, device=cuda)
    traces = fleet16._lower(readme_fleet_workload(), "replicate")
    prog4 = P.compile_fleet_program(traces, fleet16.specs,
                                    [d.lat for d in fleet16.devices],
                                    jitter=True, seeds=list(range(16)),
                                    cache=False)
    svc4 = np.concatenate([
        P.compute_service_times(traces[b], fleet16.devices[b].lat,
                                seed=b)[prog4.orders[b]] for b in range(16)])
    # phase 3's and phase 5's programs, for the same kernel comparison
    dev = P.ZnsDevice(device=cuda)
    wl3 = (P.WorkloadSpec()
           .writes(n=100_000, size=4 * KiB, qd=4, zone=0)
           .reads(n=100_000, size=4 * KiB, qd=16, zone=100, nzones=64)
           .resets(n=100, occupancy=1.0, io_ctx=OpType.WRITE))
    prog3 = P.compile_program(wl3.build(), dev.spec, dev.lat, jitter=True,
                              seed=0, cache=False)
    svc3 = P.compute_service_times(wl3.build(), dev.lat,
                                   seed=0)[prog3.orders[0]]
    wl5 = P.WorkloadSpec()
    for t in range(4):
        wl5 = wl5.appends(n=5000, size=8 * KiB, qd=4, zone=t * 4, nzones=4)
        wl5 = wl5.appends(n=5000, size=64 * KiB, qd=4, zone=t * 4, nzones=4)
    wl5 = wl5.resets(n=200, occupancy=1.0, nzones=200,
                     io_ctx=OpType.APPEND, zone=500)
    fleet5 = P.DeviceFleet.from_profiles(["ours", "nvmevirt", "femu"],
                                         device=cuda)
    traces5 = fleet5._lower(wl5, "replicate")
    prog5 = P.compile_fleet_program(traces5, fleet5.specs,
                                    [d.lat for d in fleet5.devices],
                                    jitter=True, seeds=[0, 1, 2],
                                    cache=False)
    svc5 = np.concatenate([
        P.compute_service_times(traces5[b], fleet5.devices[b].lat,
                                seed=b)[prog5.orders[b]] for b in range(3)])
    # phase 13's program: the experiment runner's one fleet, a member per
    # sweep point of the 15 observations, jitter-free
    runner13 = ExperimentRunner(backend="vectorized", device=cuda)
    fleet13, wls13, seeds13 = runner13.fleet()
    prog13 = P.compile_fleet_program([w.build() for w in wls13],
                                     fleet13.specs,
                                     [d.lat for d in fleet13.devices],
                                     seeds=seeds13, cache=False)
    svc13 = prog13.svc0_flat

    for label, prog, svcp, budget in (("phase-4", prog4, svc4, 8),
                                      ("phase-3", prog3, svc3, 8),
                                      ("phase-5", prog5, svc5, 64),
                                      ("phase-13", prog13, svc13, 8)):
        blocks = [blk.rows_view() for blk in prog.families]
        print(f"[2] {label} program: n={prog.n_flat}, blocks "
              f"{[tuple(g.shape) for g, _ in blocks]}, sweep budget "
              f"{budget}")
        packed = kfix.pack_blocks(blocks, prog.n_flat, cuda)
        for dtype in (torch.float32, torch.float64):
            c0 = torch.as_tensor(prog.issue_flat + svcp, dtype=dtype,
                                 device=cuda)
            s = torch.as_tensor(svcp, dtype=dtype, device=cuda)

            def solve(impl, c0=c0, s=s, packed=packed, budget=budget):
                return ops.zns_fixpoint(c0, s, packed, sweeps=budget,
                                        impl=impl)

            got = solve("cuda")
            launch = dict(kfix.zns_fixpoint.last_launch)
            log = []
            want = kfix.zns_fixpoint_torch(c0, s, packed, sweeps=budget,
                                           active_log=log)
            tol = F64 if dtype == torch.float64 else F32
            err = close(got[0].cpu().numpy(), want[0].cpu().numpy(), tol,
                        f"zns_fixpoint {label} {dtype}")
            check(got[2] == want[2] and got[2],
                  f"zns_fixpoint {label} {dtype}: converged {got[2]} vs "
                  f"{want[2]}")
            if dtype == torch.float64:
                check(got[1] == want[1], f"zns_fixpoint {label} float64: "
                                         f"sweeps {got[1]} vs {want[1]}")
            ms = time_ms(lambda: solve("cuda"), flush=flush)
            kms, nk = device_ms(lambda: solve("cuda"), "fp_solve_kernel")
            check(nk == 1, f"zns_fixpoint {label}: {nk} device kernels a "
                           f"solve")
            pms = time_ms(lambda: solve("torch"), reps=3, flush=flush)
            lanes = sum(packed.shapes[f][1] * packed.shapes[f][2]
                        for sweep in log for f in sweep)
            print(f"[2] zns_fixpoint {label} {dtype}: sweeps {got[1]} "
                  f"(plain {want[1]}), converged {got[2]}, active blocks "
                  f"per sweep {[len(x) for x in log]}, lanes {lanes}, max "
                  f"abs err {err:.3e}, kernel {ms:.4f} ms (device {kms} "
                  f"ms, {nk} device kernel a solve; grid {launch['grid']} "
                  f"of {launch['resident_blocks']} resident blocks, "
                  f"{launch['registers']} registers), plain {pms:.4f} ms")
            if dtype != torch.float64:
                continue
            b, by = bound_ms(29.0 * lanes, 4.0 * lanes, "float64")
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                       bound_by=by, library_ms=None, kernel_ms=kms,
                       kernels_per_solve=nk, sweeps=got[1], budget=budget,
                       lanes=lanes, dtype="float64", **launch)
            if label == "phase-4":
                report["zns_fixpoint"] = row
            else:
                report["zns_fixpoint"][label] = row

    # -- phase 2, the stacked fixpoint: every shard of a plan in one launch --
    def stack_inputs(prog, svcp, plan, packed, dtype):
        """The flat (total,) init and service vectors of a plan's shards,
        every shard's dead slot the sentinel / 0 (as the mesh executor
        builds them)."""
        init = np.full(packed.total, -np.inf)
        sv = np.zeros(packed.total)
        for sh, b in zip(plan.shards, packed.base):
            init[b:b + len(sh.perm)] = (prog.issue_flat[sh.perm]
                                        + svcp[sh.perm])
            sv[b:b + len(sh.perm)] = svcp[sh.perm]
        return (torch.as_tensor(init, dtype=dtype, device=cuda),
                torch.as_tensor(sv, dtype=dtype, device=cuda))

    for label, prog, svcp, budget in (("phase-13", prog13, svc13, 8),
                                      ("phase-5", prog5, svc5, 64)):
        plan = pshard.shard_program(prog)
        packed = kfix.pack_shards(
            [([b.rows_view() for b in sh.program.families],
              sh.program.n_flat, P.block_adjacency(sh.program))
             for sh in plan.shards], cuda)
        print(f"[2] {label} signature plan: {plan.n_shards} shards, events "
              f"{[sh.n_events for sh in plan.shards]}, blocks "
              f"{[len(sh.program.families) for sh in plan.shards]}, "
              f"{packed.tiles(2048)} tiles in the widest "
              f"slot")
        for dtype in (torch.float32, torch.float64):
            c0, sv = stack_inputs(prog, svcp, plan, packed, dtype)

            def stacked(impl, c0=c0, sv=sv, packed=packed, budget=budget):
                return ops.zns_fixpoint_sharded(c0, sv, packed,
                                                sweeps=budget, impl=impl)

            got = stacked("cuda")
            launch = dict(kfix.zns_fixpoint_sharded.last_launch)
            want = stacked("torch")
            tol = F64 if dtype == torch.float64 else F32
            err, lanes = 0.0, 0
            for k, (sh, b) in enumerate(zip(plan.shards, packed.base)):
                n = len(sh.perm)
                log = []
                kfix.zns_fixpoint_torch(c0[b:b + n], sv[b:b + n],
                                        packed.shard(k), sweeps=budget,
                                        active_log=log)
                lanes += sum(packed.shapes[k][f][1] * packed.shapes[k][f][2]
                             for sweep in log for f in sweep)
                one = ops.zns_fixpoint(c0[b:b + n], sv[b:b + n],
                                       packed.shard(k), sweeps=budget,
                                       impl="cuda")
                for other, what in ((want[0][b:b + n], "plain version"),
                                    (one[0], "single-program kernel")):
                    err = max(err, close(
                        got[0][b:b + n].cpu().numpy(), other.cpu().numpy(),
                        tol, f"zns_fixpoint_sharded {label} {dtype} shard "
                             f"{k} against the {what}"))
                check(bool(got[2][k]) == bool(want[2][k]) == one[2]
                      and one[2],
                      f"zns_fixpoint_sharded {label} {dtype} shard {k}: "
                      f"converged {got[2][k]}, plain {want[2][k]}, single "
                      f"{one[2]}")
                if dtype == torch.float64:
                    check(got[1][k] == want[1][k] == one[1],
                          f"zns_fixpoint_sharded {label} float64 shard {k}: "
                          f"sweeps {got[1][k]}, plain {want[1][k]}, single "
                          f"{one[1]}")
            ms = time_ms(lambda: stacked("cuda"), flush=flush)
            kms, nk = device_ms(lambda: stacked("cuda"), "fp_")
            check(nk == 1, f"zns_fixpoint_sharded {label}: {nk} device "
                           f"kernels a solve")
            pms = time_ms(lambda: stacked("torch"), reps=3, flush=flush)
            # the yardstick: the single-program kernel on the whole program
            w0 = torch.as_tensor(prog.issue_flat + svcp, dtype=dtype,
                                 device=cuda)
            w1 = torch.as_tensor(svcp, dtype=dtype, device=cuda)
            whole = kfix.pack_blocks([blk.rows_view()
                                      for blk in prog.families],
                                     prog.n_flat, cuda)
            sms = time_ms(lambda: ops.zns_fixpoint(w0, w1, whole,
                                                   sweeps=budget,
                                                   impl="cuda"),
                          flush=flush)
            skms, _ = device_ms(lambda: ops.zns_fixpoint(
                w0, w1, whole, sweeps=budget, impl="cuda"),
                "fp_solve_kernel")
            if label == "phase-13":
                check(launch["instance"] == "cluster",
                      f"zns_fixpoint_sharded {label}: the {launch['instance']}"
                      f" instance (want the cluster instance)")
            print(f"[2] zns_fixpoint_sharded {label} {dtype}: {plan.n_shards} "
                  f"shards in one launch ({launch['instance']} instance: "
                  f"clusters of {launch['cluster']}, {launch['clusters']} "
                  f"clusters, {launch['rounds']} rounds, widest pass "
                  f"{launch['widest']} tiles), sweeps {got[1].tolist()} (plain "
                  f"{want[1].tolist()}), all converged, lanes {lanes}, max "
                  f"abs err {err:.3e} (plain and single kernel shard by "
                  f"shard), kernel {ms:.4f} ms (device {kms} ms, {nk} device "
                  f"kernel a solve; grid {launch['grid']} of "
                  f"{launch['resident_blocks']} resident blocks, "
                  f"{launch['registers']} registers), plain {pms:.4f} ms; "
                  f"the single-program kernel on the whole program "
                  f"{sms:.4f} ms (device {skms} ms)")
            if dtype != torch.float64:
                continue
            b, by = bound_ms(29.0 * lanes, 4.0 * lanes, "float64")
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b,
                       bound_by=by, library_ms=None, kernel_ms=kms,
                       kernels_per_solve=nk, single_ms=sms,
                       single_kernel_ms=skms, sweeps=got[1].tolist(), budget=budget, lanes=lanes,
                       dtype="float64", **launch)
            if label == "phase-13":
                report["zns_fixpoint_sharded"] = row
            else:
                report["zns_fixpoint_sharded"][label] = row

    # -- phase 2, serving kernels: flash attention and RMSNorm --------------
    gen = torch.Generator(cuda).manual_seed(1)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda) * scale).to(
            dtype)

    def sdpa(q, k, v, causal, window):
        tq, tk = q.shape[2], k.shape[2]
        if window is None and (tq == tk or not causal):
            return lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal and tq == tk, enable_gqa=True)
        if window is None and tq == 1:       # end-aligned: sees every key
            return lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True)
        mask = kref.attention_mask(tq, tk, causal, window, cuda)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)

    family_attn = {}
    for case, (b, hq, hkv, tq, tk, d), window in (
            ("prefill", (1, 32, 8, 2048, 2048, 128), None),
            ("decode", (1, 32, 8, 1, 2048, 128), None),
            ("window", (1, 8, 2, 512, 512, 64), 256),
            ("d256", (2, 16, 1, 3072, 3072, 256), 2048),
            ("moe", (2, 16, 16, 1024, 1024, 128), None),
            ("musicgen", (2, 32, 32, 1024, 1024, 64), None),
            ("internvl2", (2, 48, 8, 1024, 1024, 128), None)):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            q = randn((b, hq, tq, d), dtype)
            k = randn((b, hkv, tk, d), dtype)
            v = randn((b, hkv, tk, d), dtype)
            got = ops.attention(q, k, v, window=window, impl="cuda")
            want = ops.attention(q, k, v, window=window, impl="torch")
            torch.cuda.synchronize()
            err = close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                        ATTN_TOL[dname], f"flash_attention {case} {dname}")
            ms = time_ms(lambda: ops.attention(q, k, v, window=window,
                                               impl="cuda"), flush=flush)
            pms = time_ms(lambda: ops.attention(q, k, v, window=window,
                                                impl="torch"), reps=3,
                          flush=flush)
            lib = sdpa(q, k, v, True, window)
            lib_err = float((lib().float() - got.float()).abs().max())
            lms = time_ms(lib, flush=flush)
            pairs = int(kref.attention_mask(tq, tk, True, window,
                                            cuda).sum())
            nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
            flop = 4.0 * b * hq * d * pairs
            bnd, by = bound_ms(nbytes, flop, dname)
            print(f"[2] flash_attention {case} q {tuple(q.shape)} k "
                  f"{tuple(k.shape)} window {window} {dname}: max abs err "
                  f"{err:.3e} (library {lib_err:.3e}), kernel {ms:.4f} ms "
                  f"({flop / ms / 1e9:.1f} TFLOP/s, {ms / lms:.2f}x SDPA), "
                  f"plain {pms:.4f} ms, library {lms:.4f} ms, bound "
                  f"{bnd:.4f} ms ({by})")
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd,
                       bound_by=by, library_ms=lms,
                       tflops=flop / ms / 1e9, vs_library=ms / lms,
                       shape=[list(q.shape), list(k.shape)], dtype=dname)
            if case == "prefill" and dname == "bfloat16":
                report["flash_attention"] = row
            if case == "d256" and dname == "bfloat16":
                d256 = dict(row, window=window)
            if case == "moe" and dname == "bfloat16":
                moe_attn = row       # qwen2-moe-a2.7b's prefill (MHA)
            if case in ("musicgen", "internvl2") and dname == "bfloat16":
                family_attn[case] = row     # phases 20-21's prefills
            del q, k, v, got, want

    for rows, d in ((2048, 2560), (2048 * 32, 128)):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            x = randn((rows, d), dtype)
            w = randn((d,), torch.float32, 0.1)
            got = ops.rmsnorm(x, w, eps=1e-6, impl="cuda")
            want = ops.rmsnorm(x, w, eps=1e-6, impl="torch")
            torch.cuda.synchronize()
            err = close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                        RMS_TOL[dname], f"rmsnorm ({rows}, {d}) {dname}")
            ms = time_ms(lambda: ops.rmsnorm(x, w, impl="cuda"), flush=flush)
            pms = time_ms(lambda: ops.rmsnorm(x, w, impl="torch"), reps=3,
                          flush=flush)
            wl = (1.0 + w).to(dtype)
            lms = time_ms(lambda: F.rms_norm(x, (d,), weight=wl, eps=1e-6),
                          flush=flush)
            nbytes = 2.0 * x.numel() * x.element_size() + 4 * d
            bnd, by = bound_ms(nbytes, 4.0 * x.numel(), dname)
            print(f"[2] rmsnorm ({rows}, {d}) {dname}: max abs err "
                  f"{err:.3e}, kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} "
                  f"GB/s), plain {pms:.4f} ms, library {lms:.4f} ms, bound "
                  f"{bnd:.4f} ms ({by})")
            if (rows, d) == (2048, 2560) and dname == "bfloat16":
                report["rmsnorm"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd,
                    bound_by=by, library_ms=lms, gbps=nbytes / ms / 1e6,
                    shape=[rows, d], dtype=dname)
            del x, got, want


    # -- phase 2, the backward kernels: attention and RMSNorm ---------------
    def bwd_close(got, want, dname, what):
        rtol, frac = BWD_TOL[dname]
        scale = float(want.float().abs().max())
        return close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                     dict(rtol=rtol, atol=frac * scale), what)

    def sdpa_backend(fn):
        """The SDPA backend one call of ``fn`` ran, from its device
        kernels' names under ``torch.profiler``."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = " ".join(e.name for e in prof.events()).lower()
        for key, backend in (("flash", "flash"), ("cudnn", "cudnn"),
                             ("fmha", "efficient"), ("efficient",
                                                     "efficient")):
            if key in names:
                return backend
        return "math" if names else "none"

    fwd_ms, bwd_d256 = {}, {}
    for case, (b, hq, hkv, tq, tk, d), window in (
            ("tinyllama", (4, 32, 4, 2048, 2048, 64), None),
            ("qwen3", (1, 32, 8, 2048, 2048, 128), None),
            # recurrentgemma-9b's attention in phase 24's training: MQA at
            # D 256, window 2,048 of 4,096 tokens
            ("recurrentgemma", (1, 16, 1, 4096, 4096, 256), 2048)):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            q = randn((b, hq, tq, d), dtype)
            k = randn((b, hkv, tk, d), dtype)
            v = randn((b, hkv, tk, d), dtype)
            do = randn((b, hq, tq, d), dtype)
            out, lse = kfa.flash_attention(q, k, v, window=window,
                                           return_lse=True)
            check(torch.equal(out, kfa.flash_attention(q, k, v,
                                                       window=window)),
                  f"flash_attention {case} {dname}: the output with lse "
                  f"differs from the one without")
            got = kfa.flash_attention_bwd(q, k, v, out, do, lse,
                                          window=window)
            want = kfa.attention_bwd_torch(q, k, v, out, do, lse,
                                           window=window)
            torch.cuda.synchronize()
            err = max(bwd_close(g, w, dname, f"flash_attention_bwd {case} "
                                             f"{dname} d{n}")
                      for g, w, n in zip(got, want, "qkv"))
            again = kfa.flash_attention_bwd(q, k, v, out, do, lse,
                                            window=window)
            check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                  f"flash_attention_bwd {case} {dname}: two runs differ")
            auto = ""
            if window is not None:   # autograd through the plain forward
                qa, ka, va = (t.detach().requires_grad_(True)
                              for t in (q, k, v))
                ref_g = torch.autograd.grad(
                    kfa.attention_torch(qa, ka, va, window=window),
                    (qa, ka, va), do)
                aerr = max(bwd_close(g, w, dname, f"flash_attention_bwd "
                                                  f"{case} {dname} d{n} "
                                                  f"against autograd")
                           for g, w, n in zip(got, ref_g, "qkv"))
                auto = f", against autograd of the plain forward {aerr:.3e}"
                del qa, ka, va, ref_g
            ms = time_ms(lambda: kfa.flash_attention_bwd(
                q, k, v, out, do, lse, window=window), flush=flush)
            pms = time_ms(lambda: kfa.attention_bwd_torch(
                q, k, v, out, do, lse, window=window), reps=3, flush=flush)
            # the library: SDPA's backward through autograd
            ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
            lo = sdpa(ql, kl, vl, True, window)()
            backend = sdpa_backend(lambda: torch.autograd.grad(
                lo, (ql, kl, vl), do, retain_graph=True))
            lms = time_ms(lambda: torch.autograd.grad(
                lo, (ql, kl, vl), do, retain_graph=True), flush=flush)
            lib_err = max(float((a.float() - g.float()).abs().max())
                          for a, g in zip(torch.autograd.grad(
                              lo, (ql, kl, vl), do), got))
            if dname == "bfloat16" and case == "qwen3":
                fwd_ms = dict(
                    plain=time_ms(lambda: kfa.flash_attention(q, k, v),
                                  flush=flush),
                    lse=time_ms(lambda: kfa.flash_attention(
                        q, k, v, return_lse=True), flush=flush))
            pairs = int(kref.attention_mask(tq, tk, True, window,
                                            cuda).sum())
            flop = 2.5 * 4.0 * b * hq * d * pairs
            nbytes = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
                      + 4.0 * lse.numel())
            bnd, by = bound_ms(nbytes, flop, dname)
            # the query-head groups of the dK/dV grid and, at D 256, the
            # device ms by kernel (bf16: delta, dK/dV, the groups' sum,
            # dQ; float32: delta, then dK/dV and dQ in one launch)
            groups = kfa.flash_attention_bwd.last_plan.groups
            split = (kernel_split(lambda: kfa.flash_attention_bwd(
                q, k, v, out, do, lse, window=window), "bwd_")
                if case == "recurrentgemma" else None)
            print(f"[2] flash_attention_bwd {case} q {tuple(q.shape)} k "
                  f"{tuple(k.shape)} causal, window {window}, {dname}: max "
                  f"abs err {err:.3e}{auto} (SDPA's gradients {lib_err:.3e} "
                  f"from the kernel's), two runs bit-equal, kernel "
                  f"{ms:.4f} ms ({flop / ms / 1e9:.1f} TFLOP/s, "
                  f"{ms / lms:.2f}x SDPA's backward), plain {pms:.4f} ms, "
                  f"library {lms:.4f} ms (SDPA backend: {backend}), bound "
                  f"{bnd:.4f} ms ({by}); head groups G {groups}"
                  + (f"; device ms by kernel {split}" if split else ""))
            row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd,
                       bound_by=by, library_ms=lms, library_err=lib_err,
                       library_backend=backend, tflops=flop / ms / 1e9,
                       vs_library=ms / lms, window=window,
                       shape=[list(q.shape), list(k.shape)], dtype=dname,
                       head_groups=groups, split=split)
            if dname == "bfloat16" and case == "tinyllama":
                report["flash_attention_bwd"] = row
            elif case == "recurrentgemma":
                bwd_d256[dname] = row
            elif dname == "bfloat16":
                qwen3_bwd = row
            del q, k, v, do, out, lse, got, want, again, ql, kl, vl, lo
            torch.cuda.empty_cache()
    report["flash_attention_bwd"]["qwen3"] = qwen3_bwd
    report["flash_attention_bwd_d256"] = dict(
        bwd_d256["bfloat16"], float32=bwd_d256["float32"],
        float32_vs_library=bwd_d256["float32"]["vs_library"])
    print(f"[2] flash_attention forward at qwen3's prefill, bfloat16: "
          f"without lse {fwd_ms['plain']:.4f} ms (PR 19: "
          f"{ATTN_FWD_PR19_MS} ms), with lse {fwd_ms['lse']:.4f} ms")

    for rows, d in ((8192, 2048), (4 * 2048 * 32, 128)):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            x = randn((rows, d), dtype)
            dy = randn((rows, d), dtype)
            w = randn((d,), torch.float32, 0.1)
            dx, dw = krms.rmsnorm_bwd(x, w, dy)
            dx_p, dw_p = krms.rmsnorm_bwd_torch(x, w, dy)
            torch.cuda.synchronize()
            err = bwd_close(dx, dx_p, dname, f"rmsnorm_bwd ({rows}, {d}) "
                                             f"{dname} dx")
            err_w = close(dw.cpu().numpy(), dw_p.cpu().numpy(),
                          dict(rtol=1e-3, atol=1e-4 * rows ** 0.5),
                          f"rmsnorm_bwd ({rows}, {d}) {dname} dw")
            again = krms.rmsnorm_bwd(x, w, dy)
            check(torch.equal(again[0], dx) and torch.equal(again[1], dw),
                  f"rmsnorm_bwd ({rows}, {d}) {dname}: two runs differ")
            ms = time_ms(lambda: krms.rmsnorm_bwd(x, w, dy), flush=flush)
            dms, nk = device_ms(lambda: krms.rmsnorm_bwd(x, w, dy),
                                "rmsnorm", reps=9)
            check(nk <= 2, f"rmsnorm_bwd ({rows}, {d}) {dname}: {nk} device "
                           f"kernels a call, want 2 (the rows, then the dw "
                           f"sum)")
            if nk < 2:    # the profiler dropped a kernel in every window
                dms = None
            pms = time_ms(lambda: krms.rmsnorm_bwd_torch(x, w, dy), reps=3,
                          flush=flush)
            xl = x.detach().requires_grad_(True)
            wl = (1.0 + w).to(dtype).requires_grad_(True)
            lo = F.rms_norm(xl, (d,), weight=wl, eps=1e-6)
            lms = time_ms(lambda: torch.autograd.grad(
                lo, (xl, wl), dy, retain_graph=True), flush=flush)
            nbytes = 3.0 * x.numel() * x.element_size() + 8 * d
            bnd, by = bound_ms(nbytes, 8.0 * x.numel(), dname)
            dtxt = (f"{dms:.4f} ms ({bnd / dms:.0%} of the bound)"
                    if dms is not None else "not measured")
            print(f"[2] rmsnorm_bwd ({rows}, {d}) {dname}: max abs err dx "
                  f"{err:.3e}, dw {err_w:.3e}, two runs bit-equal, kernel "
                  f"{ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
                  f"{bnd / ms:.0%} of the bound; device time {dtxt}, {nk} "
                  f"device kernels a call), plain {pms:.4f} ms, library "
                  f"(F.rms_norm's backward) {lms:.4f} ms, bound {bnd:.4f} "
                  f"ms ({by})")
            row = dict(max_abs_err=max(err, err_w), ms=ms, plain_ms=pms,
                       bound_ms=bnd, bound_by=by, library_ms=lms,
                       gbps=nbytes / ms / 1e6, device_ms=dms,
                       device_kernels=nk, bound_share=bnd / ms,
                       shape=[rows, d], dtype=dname)
            if (rows, d) == (8192, 2048) and dname == "bfloat16":
                report["rmsnorm_bwd"] = row
            elif dname == "bfloat16":
                report["rmsnorm_bwd"]["qk_norm"] = row
            del x, dy, dx, dw, dx_p, dw_p, again, xl, wl, lo
    print("[2] rmsnorm_bwd kernels (ptxas -v): " + "; ".join(
        f"{kern} {regs} registers, {spill}" for kern, regs, spill
        in ptxas["rmsnorm"] if kern.startswith(("rmsnorm_bwd",
                                                "rmsnorm_dw"))))

    # -- phase 2, rows cut over ranks: Mamba2's gated norm on its heads -----
    # A rank's d of the rows' 2,048 columns (1,024 on 25m's model 2, 128
    # on a model axis of 16); the other ranks' sums come from ``reduce``,
    # here the sums of random columns standing for theirs.
    width, rows = CUT_NORM_WIDTH, CUT_NORM_ROWS
    for d in (width // 2, width // 16):
        for dname in ("bfloat16", "float32"):
            dtype = getattr(torch, dname)
            x, dy = randn((rows, d), dtype), randn((rows, d), dtype)
            w = randn((d,), torch.float32, 0.1)
            xo, go = (randn((rows, width - d), dtype) for _ in range(2))
            wo = randn((width - d,), torch.float32, 0.1)
            ss_o = (xo.float() ** 2).sum(-1)
            dot_o = (go.float() * (1 + wo) * xo.float()).sum(-1)

            def red_ss(t):
                return t + ss_o

            def red_dot(t):
                return t + dot_o

            got = krms.rmsnorm_cut(x, w, red_ss, width=width)
            want = krms.rmsnorm_cut_torch(x, w, red_ss, width=width)
            whole = ops.rmsnorm(torch.cat([x, xo], -1), torch.cat([w, wo]),
                                impl="torch")[:, :d]
            torch.cuda.synchronize()
            what = f"rmsnorm_cut ({rows}, {d} of {width}) {dname}"
            err = close(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), RMS_TOL[dname], what)
            err_whole = close(got.float().cpu().numpy(),
                              whole.float().cpu().numpy(), RMS_TOL[dname],
                              what + " against the whole rows")
            ms = time_ms(lambda: krms.rmsnorm_cut(x, w, red_ss, width=width),
                         flush=flush)
            pms = time_ms(lambda: krms.rmsnorm_cut_torch(
                x, w, red_ss, width=width), reps=3, flush=flush)
            # x and w read once, y written, the summed squares read
            nbytes = 2.0 * x.numel() * x.element_size() + 4 * d + 4 * rows
            bnd, by = bound_ms(nbytes, 4.0 * x.numel(), dname)
            ss = red_ss((x.float() ** 2).sum(-1))
            dx, dw = krms.rmsnorm_cut_bwd(x, w, dy, ss, red_dot, width=width)
            dx_p, dw_p = krms.rmsnorm_cut_bwd_torch(x, w, dy, ss, red_dot,
                                                    width=width)
            torch.cuda.synchronize()
            err_b = bwd_close(dx, dx_p, dname, what + " backward dx")
            err_w = close(dw.cpu().numpy(), dw_p.cpu().numpy(),
                          dict(rtol=1e-3, atol=1e-4 * rows ** 0.5),
                          what + " backward dw")
            again = krms.rmsnorm_cut_bwd(x, w, dy, ss, red_dot, width=width)
            check(torch.equal(again[0], dx) and torch.equal(again[1], dw),
                  f"{what} backward: two runs differ")
            bms = time_ms(lambda: krms.rmsnorm_cut_bwd(
                x, w, dy, ss, red_dot, width=width), flush=flush)
            bpms = time_ms(lambda: krms.rmsnorm_cut_bwd_torch(
                x, w, dy, ss, red_dot, width=width), reps=3, flush=flush)
            # x, dy and w read once, dx and dw written, the summed squares
            # and dot products read
            bbytes = 3.0 * x.numel() * x.element_size() + 8 * d + 8 * rows
            bbnd, bby = bound_ms(bbytes, 8.0 * x.numel(), dname)
            print(f"[2] {what}: max abs err {err:.3e} vs its plain version, "
                  f"{err_whole:.3e} vs the whole rows' norm; kernel {ms:.4f} "
                  f"ms ({nbytes / ms / 1e6:.0f} GB/s), plain {pms:.4f} ms, "
                  f"library none, bound {bnd:.4f} ms ({by}); backward: max "
                  f"abs err dx {err_b:.3e}, dw {err_w:.3e}, two runs "
                  f"bit-equal, kernel {bms:.4f} ms ({bbytes / bms / 1e6:.0f} "
                  f"GB/s), plain {bpms:.4f} ms, bound {bbnd:.4f} ms ({bby})")
            fwd_row = dict(max_abs_err=max(err, err_whole), ms=ms,
                           plain_ms=pms, bound_ms=bnd, bound_by=by,
                           library_ms=None, gbps=nbytes / ms / 1e6,
                           shape=[rows, d, width], dtype=dname)
            bwd_row = dict(max_abs_err=max(err_b, err_w), ms=bms,
                           plain_ms=bpms, bound_ms=bbnd, bound_by=bby,
                           library_ms=None, gbps=bbytes / bms / 1e6,
                           shape=[rows, d, width], dtype=dname)
            sub = f"{dname}_{d}"
            if d == width // 2 and dname == "bfloat16":
                report["rmsnorm_cut"], report["rmsnorm_cut_bwd"] = \
                    fwd_row, bwd_row
            else:
                report["rmsnorm_cut"][sub] = fwd_row
                report["rmsnorm_cut_bwd"][sub] = bwd_row
            del x, dy, w, xo, go, wo, got, want, whole, dx, dw, dx_p, dw_p
            del again, ss, ss_o, dot_o

    report["flash_attention"]["d256"] = d256
    report["flash_attention"]["moe"] = moe_attn
    report["flash_attention"].update(family_attn)
    # the bf16 attention kernels run on the tensor cores: count the wgmma
    # of each function
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")

    def sass_counts(source, op):
        """{function: instructions holding op} of a built library
        (cuobjdump -sass), and the whole listing."""
        sass = subprocess.run([cuobjdump, "-sass",
                               str(_build.library_path(source))],
                              capture_output=True, text=True, timeout=300)
        counts, fn = {}, None
        for line in sass.stdout.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = kernel_name(m.group(1))
                counts[fn] = 0
            elif fn is not None and op in line:
                counts[fn] += 1
        return counts, sass.stdout

    hgmma, _ = sass_counts("flash_attention", "HGMMA")
    fwd_hg = {f: n for f, n in hgmma.items()
              if f.startswith("flash_fwd_wgmma")}
    bwd_hg = {f: n for f, n in hgmma.items()
              if f.startswith(("bwd_dkdv_wgmma", "bwd_dq_wgmma"))}
    print(f"[2] flash_attention library: HGMMA (wgmma) instructions by "
          f"function (cuobjdump -sass): forward {fwd_hg}, backward "
          f"{bwd_hg}")
    check(fwd_hg and all(fwd_hg.values()),
          f"flash_attention: a forward function without HGMMA: {fwd_hg}")
    check(len(bwd_hg) == 10 and all(bwd_hg.values()),
          f"flash_attention: a bfloat16 backward function without HGMMA "
          f"(want dK/dV and dQ at 5 head dims, D 256 too): {bwd_hg}")
    report["flash_attention"]["hgmma"] = sum(fwd_hg.values())
    report["flash_attention_bwd"]["hgmma"] = bwd_hg

    # -- phase 2, recurrent kernels: SSD chunk scan, linear recurrence ------
    t2, h2, p2, g2, n2, chunk = 2048, 32, 64, 1, 128, 128
    for bb in (4, 1):        # mamba2-370m's prefill; batch 1 fills 32 SMs
        x = randn((bb, t2, h2, p2), torch.bfloat16, 0.5)
        dt = (torch.rand((bb, t2, h2), generator=gen, device=cuda) * 0.099
              + 0.001)
        A = -(torch.rand((h2,), generator=gen, device=cuda) * 1.5 + 0.5)
        Bm = randn((bb, t2, g2, n2), torch.bfloat16, 0.3)
        Cm = randn((bb, t2, g2, n2), torch.bfloat16, 0.3)
        args = (x, dt, A, Bm, Cm)
        y, st = ops.ssd_scan(*args, chunk=chunk, impl="cuda")
        yw, sw = ops.ssd_scan(*args, chunk=chunk, impl="torch")
        torch.cuda.synchronize()
        err = close(y.float().cpu().numpy(), yw.float().cpu().numpy(),
                    SSD_TOL["bfloat16"], f"ssd_chunk_scan y, batch {bb}")
        serr = close(st.cpu().numpy(), sw.cpu().numpy(), SSD_TOL["float32"],
                     f"ssd_chunk_scan final state, batch {bb}")
        ms = time_ms(lambda: ops.ssd_scan(*args, chunk=chunk, impl="cuda"),
                     flush=flush)
        pms = time_ms(lambda: ops.ssd_scan(*args, chunk=chunk,
                                           impl="torch"),
                      reps=3, flush=flush)
        # the causal pairs (j <= i) of each chunk, per (batch, head): C.B^T
        # and the scores times x, then the inter-chunk term and the state
        # update
        pairs = chunk * (chunk + 1) // 2
        nflop = 2.0 * bb * h2 * (t2 // chunk) * (
            pairs * n2 + pairs * p2 + 2 * chunk * n2 * p2)
        nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4
                  + 2 * Bm.numel() * Bm.element_size() + st.numel() * 4)
        bnd, by = bound_ms(nbytes, nflop, "bfloat16")
        kind = kssd.instance(x.dtype, n2)
        stages = kssd.mma_stages(chunk, p2, n2)
        print(f"[2] ssd_chunk_scan x {tuple(x.shape)} B/C {tuple(Bm.shape)} "
              f"chunk {chunk} bfloat16 ({kind} instance, {stages} stages): "
              f"max abs err y {err:.3e}, state {serr:.3e}, kernel {ms:.4f} "
              f"ms ({nflop / ms / 1e9:.1f} TFLOP/s, {ms / bnd:.2f}x the "
              f"bound), plain {pms:.4f} ms, bound {bnd:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {nflop / 1e9:.2f} GFLOP)")
        row = dict(max_abs_err=err, state_max_abs_err=serr, ms=ms,
                   plain_ms=pms, bound_ms=bnd, bound_by=by, library_ms=None,
                   tflops=nflop / ms / 1e9, vs_bound=ms / bnd,
                   instance=kind, stages=stages,
                   shape=[list(x.shape), list(Bm.shape)], dtype="bfloat16")
        if bb == 4:
            report["ssd_chunk_scan"] = row
        else:
            report["ssd_chunk_scan"]["batch1"] = row
        del x, dt, A, Bm, Cm, args, y, st, yw, sw
    hmma_fn, sass = sass_counts("ssd_chunk_scan", "HMMA")
    hmma = sum("HMMA" in line for line in sass.splitlines())
    print(f"[2] ssd_chunk_scan library: {hmma} HMMA (mma.sync) instructions "
          f"(cuobjdump -sass)")
    check(hmma > 0, "ssd_chunk_scan: no HMMA instruction in the library")
    report["ssd_chunk_scan"]["hmma"] = hmma

    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        a = (torch.rand((2, 3072, 4096), generator=gen, device=cuda) * 0.399
             + 0.6).to(dtype)
        xb = randn((2, 3072, 4096), dtype)
        got = ops.linear_recurrence(a, xb, impl="cuda")
        want = ops.linear_recurrence(a, xb, impl="torch")
        torch.cuda.synchronize()
        tol = LR_TOL if dname == "float32" else dict(rtol=1e-2, atol=2e-2)
        err = close(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    tol, f"linear_recurrence {dname}")
        ms = time_ms(lambda: ops.linear_recurrence(a, xb, impl="cuda"),
                     flush=flush)
        pms = time_ms(lambda: ops.linear_recurrence(a, xb, impl="torch"),
                      reps=3, flush=flush)
        nbytes = 3.0 * a.numel() * a.element_size()
        bnd, by = bound_ms(nbytes, 2.0 * a.numel(), "float32")
        print(f"[2] linear_recurrence {tuple(a.shape)} {dname}: max abs err "
              f"{err:.3e}, kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
              f"{bnd / ms:.1%} of the bound), plain {pms:.4f} ms, bound "
              f"{bnd:.4f} ms ({by})")
        if dname == "float32":
            report["linear_recurrence"] = dict(
                max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bnd,
                bound_by=by, library_ms=None, gbps=nbytes / ms / 1e6,
                shape=list(a.shape), dtype=dname)
        else:
            report["linear_recurrence"]["bfloat16"] = dict(
                max_abs_err=err, ms=ms, bound_ms=bnd,
                gbps=nbytes / ms / 1e6)
        del a, xb, got, want

    # -- phase 2, the recurrent backward kernels ----------------------------
    def ssd_bwd_work(bb, t, h, p, n, chunk):
        """The SSD backward's least products (multiply-adds x 2): the
        causal C.B and dy.u scores, M^T dy, Q B and Q^T C over the causal
        pairs; S_prev^T dy, dS B, dS^T u, dS's update and the states'
        recompute at L P N each."""
        pairs = chunk * (chunk + 1) // 2
        per = pairs * (2 * n + 2 * p + n) + 5 * chunk * p * n
        return 2.0 * bb * h * (t // chunk) * per

    a24 = (torch.rand((1, 4096, 4096), generator=gen, device=cuda) * 0.399
           + 0.6)
    b24, dh24 = randn((1, 4096, 4096), torch.float32), \
        randn((1, 4096, 4096), torch.float32)
    h24 = klr.linear_recurrence(a24, b24)
    got = klr.linear_recurrence_bwd(a24, h24, dh24)
    want = klr.linear_recurrence_bwd_torch(a24, h24, dh24)
    xa, xb = a24.clone().requires_grad_(True), b24.clone().requires_grad_(True)
    auto = torch.autograd.grad(klr.linear_recurrence_torch(xa, xb), (xa, xb),
                               dh24)
    torch.cuda.synchronize()
    err = max(bwd_close(g, w, "float32", f"linear_recurrence_bwd d{nm}")
              for g, w, nm in zip(got, want, "ab"))
    aerr = max(bwd_close(g, w, "float32", f"linear_recurrence_bwd d{nm} "
                                          f"against autograd")
               for g, w, nm in zip(got, auto, "ab"))
    again = klr.linear_recurrence_bwd(a24, h24, dh24)
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          "linear_recurrence_bwd: two runs differ")
    ms = time_ms(lambda: klr.linear_recurrence_bwd(a24, h24, dh24),
                 flush=flush)
    pms = time_ms(lambda: klr.linear_recurrence_bwd_torch(a24, h24, dh24),
                  reps=3, flush=flush)
    nbytes = 5.0 * a24.numel() * 4
    bnd, by = bound_ms(nbytes, 3.0 * a24.numel(), "float32")
    print(f"[2] linear_recurrence_bwd {tuple(a24.shape)} float32 "
          f"(recurrentgemma-9b's training shape): max abs err {err:.3e}, "
          f"against autograd of the plain forward {aerr:.3e}, two runs "
          f"bit-equal, kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s, "
          f"{bnd / ms:.1%} of the bound), plain {pms:.4f} ms, library none, "
          f"bound {bnd:.4f} ms ({by})")
    report["linear_recurrence_bwd"] = dict(
        max_abs_err=max(err, aerr), ms=ms, plain_ms=pms, bound_ms=bnd,
        bound_by=by, library_ms=None, gbps=nbytes / ms / 1e6,
        shape=list(a24.shape), dtype="float32")
    del a24, b24, dh24, h24, got, want, xa, xb, auto, again

    t23, h23, p23, n23, c23 = 2048, 32, 64, 128, 128
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        x = randn((4, t23, h23, p23), dtype, 0.5)
        dt = (torch.rand((4, t23, h23), generator=gen, device=cuda) * 0.099
              + 0.001)
        A = -(torch.rand((h23,), generator=gen, device=cuda) * 1.5 + 0.5)
        Bm = randn((4, t23, 1, n23), dtype, 0.3)
        Cm = randn((4, t23, 1, n23), dtype, 0.3)
        dy = randn((4, t23, h23, p23), dtype)
        ds = randn((4, h23, p23, n23), torch.float32, 0.1)
        args = (x, dt, A, Bm, Cm, dy, ds)
        got = kssd.ssd_chunk_scan_bwd(*args, chunk=c23)
        want = kssd.ssd_bwd_torch(*args, chunk=c23)
        req = [u.clone().requires_grad_(True) for u in (x, dt, A, Bm, Cm)]
        y_, s_ = kssd.ssd_torch(*req, chunk=c23)
        auto = torch.autograd.grad((y_, s_), req, (dy, ds))
        torch.cuda.synchronize()
        names = ("dx", "ddt", "dA", "dB", "dC")
        err = max(bwd_close(g, w, dname, f"ssd_chunk_scan_bwd {dname} {nm}")
                  for g, w, nm in zip(got, want, names))
        aerr = max(bwd_close(g, w, dname, f"ssd_chunk_scan_bwd {dname} {nm} "
                                          f"against autograd")
                   for g, w, nm in zip(got, auto, names))
        again = kssd.ssd_chunk_scan_bwd(*args, chunk=c23)
        check(all(torch.equal(u, w) for u, w in zip(got, again)),
              f"ssd_chunk_scan_bwd {dname}: two runs differ")
        ms = time_ms(lambda: kssd.ssd_chunk_scan_bwd(*args, chunk=c23),
                     flush=flush)
        dms, nk = device_ms(lambda: kssd.ssd_chunk_scan_bwd(*args,
                                                            chunk=c23),
                            "ssd_bwd", reps=5)
        pms = time_ms(lambda: kssd.ssd_bwd_torch(*args, chunk=c23), reps=3,
                      flush=flush)
        nflop = ssd_bwd_work(4, t23, h23, p23, n23, c23)
        es = x.element_size()
        nbytes = (es * (2 * x.numel() + dy.numel() + 4 * Bm.numel())
                  + 4 * (2 * dt.numel() + ds.numel() + 2 * h23))
        bnd, by = bound_ms(nbytes, nflop, dname)
        split = kernel_split(lambda: kssd.ssd_chunk_scan_bwd(*args,
                                                             chunk=c23),
                             "ssd_bwd")
        kind = kssd.bwd_instance(dtype, n23)
        cores = {"mma": "the bf16 tensor cores",
                 "simt": "the float32 cores"}[kind]
        dtxt = (f"{dms:.4f} ms in {nk} device kernels" if dms is not None
                else "not measured") + f"; by kernel {split}"
        print(f"[2] ssd_chunk_scan_bwd x {tuple(x.shape)} B/C "
              f"{tuple(Bm.shape)} chunk {c23} {dname} (mamba2-370m's "
              f"training shape; {kind} instance): max abs err {err:.3e}, "
              f"against autograd of the plain forward {aerr:.3e}, two runs "
              f"bit-equal, kernel {ms:.4f} ms ({nflop / ms / 1e9:.1f} "
              f"TFLOP/s of least products on {cores}, {ms / bnd:.2f}x the "
              f"{dname} bound; device time {dtxt}), plain {pms:.4f} ms, "
              f"library none, bound {bnd:.4f} ms ({by}; "
              f"{nbytes / 1e6:.1f} MB, {nflop / 1e9:.2f} GFLOP)")
        row = dict(max_abs_err=max(err, aerr), ms=ms, plain_ms=pms,
                   bound_ms=bnd, bound_by=by, library_ms=None,
                   device_ms=dms, device_kernels=nk, kernel_ms=split,
                   tflops=nflop / ms / 1e9, vs_bound=ms / bnd,
                   instance=kind, shape=[list(x.shape), list(Bm.shape)],
                   dtype=dname)
        if dname == "float32":
            report["ssd_chunk_scan_bwd"] = row
        else:
            report["ssd_chunk_scan_bwd"]["bfloat16"] = row
        del x, dt, A, Bm, Cm, dy, ds, args, got, want, req, y_, s_, auto, \
            again
        torch.cuda.empty_cache()
    # the bfloat16 backward's kernels run on the tensor cores: HMMA in each
    # of their functions (16 (P, N) paddings each); their registers and
    # spills
    bwd_mma = ("ssd_bwd_walk", "ssd_bwd_mma_chunk")
    bwd_hmma = {f: n for f, n in hmma_fn.items() if f.startswith(bwd_mma)}
    bwd_ptxas = [(k, r, sp) for k, r, sp in ptxas["ssd_chunk_scan"]
                 if k.startswith(bwd_mma)]
    print("[2] ssd_chunk_scan_bwd bfloat16 kernels, HMMA (mma.sync) "
          "instructions by function (cuobjdump -sass): " + ", ".join(
              f"{f} {n}" for f, n in sorted(bwd_hmma.items())))
    print("[2] ssd_chunk_scan_bwd bfloat16 kernels (ptxas -v): " + "; ".join(
        f"{k} {r} registers, {sp}" for k, r, sp in bwd_ptxas))
    f32_ptxas = [(k, r, sp) for k, r, sp in ptxas["ssd_chunk_scan"]
                 if k.startswith(("ssd_bwd_f32_walk", "ssd_bwd_f32_chunk"))]
    print("[2] ssd_chunk_scan_bwd float32 kernels (ptxas -v): " + "; ".join(
        f"{k} {r} registers, {sp}" for k, r, sp in f32_ptxas))
    check(len(f32_ptxas) == 25, f"ssd_chunk_scan_bwd: want the two float32 "
                                f"walks and 23 chunk instances, got "
                                f"{[k for k, _, _ in f32_ptxas]}")
    check(len(bwd_hmma) == 32 and all(bwd_hmma.values()),
          f"ssd_chunk_scan_bwd: a bfloat16 kernel without HMMA (want "
          f"ssd_bwd_walk and ssd_bwd_mma_chunk at 16 paddings each): "
          f"{bwd_hmma}")
    report["ssd_chunk_scan_bwd"]["bfloat16"].update(
        hmma=bwd_hmma, ptxas=[list(r) for r in bwd_ptxas])
    report["ssd_chunk_scan_bwd"]["ptxas"] = [list(r) for r in f32_ptxas]

    # -- phases 3-5: vectorized runs through the public entry points -------
    def run_phase(phase, run, ref_run, *, fleet):
        K.reset_launch_counts()
        t = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        read_counts(phase, ["zns_fixpoint"])
        ref = ref_run()
        got_rs = list(res) if fleet else [res]
        want_rs = list(ref) if fleet else [ref]
        err = max(close(g.sim.complete, w.sim.complete, F64,
                        f"phase {phase} completions")
                  for g, w in zip(got_rs, want_rs))
        check(res.converged, f"phase {phase}: not converged")
        check(res.solve_stats.driver == "cuda",
              f"phase {phase}: driver {res.solve_stats.driver}")
        return res, wall, err

    def solve_ms(prog, svc, sweeps=8):
        return time_ms(lambda: P.solve_program(prog, svc, sweeps=sweeps,
                                               device=cuda), reps=3)

    # phase 3: README ZnsDevice quickstart
    res3, wall3, err3 = run_phase(
        "3", lambda: dev.run(wl3, backend="vectorized", seed=0),
        lambda: dev.run(wl3, backend="vectorized", seed=0, fixpoint="loop",
                        scan_backend="numpy"), fleet=False)
    ms3 = solve_ms(prog3, svc3)
    print(f"[3] ZnsDevice quickstart: n={len(res3)}, IOPS {res3.iops:.1f}, "
          f"read p99 {res3.latency_stats(OpType.READ).p99_us:.3f} us, "
          f"sweeps {res3.sweeps_used}, compile "
          f"{res3.compile_stats.lowering_ms:.1f} ms, solve {ms3:.3f} ms, "
          f"run {wall3:.1f} ms, max abs err vs loop {err3:.3e}")

    # phase 4: README fleet quickstart
    res4, wall4, err4 = run_phase(
        "4", lambda: fleet16.run(readme_fleet_workload(), policy="replicate",
                                 backend="vectorized"),
        lambda: fleet16.run(readme_fleet_workload(), policy="replicate",
                            backend="vectorized", fixpoint="loop",
                            scan_backend="numpy"), fleet=True)
    ms4 = solve_ms(prog4, svc4)
    print(f"[4] fleet quickstart: devices 16, n="
          f"{sum(len(r) for r in res4)}, total IOPS {res4.total_iops:.1f}, "
          f"read p99 {res4.latency_stats(OpType.READ).p99_us:.3f} us, "
          f"sweeps {res4[0].sweeps_used}, compile "
          f"{res4.compile_stats.lowering_ms:.1f} ms, solve {ms4:.3f} ms, "
          f"run {wall4:.1f} ms, max abs err vs loop {err4:.3e}")

    # phase 5: contended heterogeneous fleet
    res5, wall5, err5 = run_phase(
        "5", lambda: fleet5.run(wl5, policy="replicate",
                                backend="vectorized", sweeps=64),
        lambda: fleet5.run(wl5, policy="replicate", backend="vectorized",
                           sweeps=64, fixpoint="loop", scan_backend="numpy"),
        fleet=True)
    check(res5.exact, "phase 5: fleet result is not exact")
    ms5 = solve_ms(prog5, svc5, sweeps=64)
    print(f"[5] contended fleet: n={sum(len(r) for r in res5)}, blocks "
          f"{len(prog5.families)}, exact {res5.exact}, total IOPS "
          f"{res5.total_iops:.1f}, sweeps {res5[0].sweeps_used}, compile "
          f"{res5.compile_stats.lowering_ms:.1f} ms, solve {ms5:.3f} ms, "
          f"run {wall5:.1f} ms, max abs err vs loop {err5:.3e}")

    # -- phase 6: sequential completions -------------------------------------
    n6 = 100_000
    issue6 = np.sort(rng.uniform(0, 1e6, n6))
    svc6 = rng.uniform(1, 30, n6)
    seg6 = np.zeros(n6, dtype=bool)
    seg6[0] = True
    lens = [int(x) for x in rng.integers(1_000, 20_000, 16)]
    rows = [(np.sort(rng.uniform(0, 1e5, k)), rng.uniform(1, 30, k),
             rng.uniform(size=k) < 0.01) for k in lens]
    K.reset_launch_counts()
    got6 = dev.sequential_completions(issue6, svc6, seg6)
    got6b = fleet16.sequential_completions([r[0] for r in rows],
                                           [r[1] for r in rows],
                                           [r[2] for r in rows])
    torch.cuda.synchronize()
    read_counts("6", ["zns_event_scan", "zns_event_scan_batched"])
    err6 = close(got6, P.zone_sequential_completions(
        issue6, svc6, seg6, backend="numpy"), F64, "phase 6 chain")
    for (i, s, g), out in zip(rows, got6b):
        err6 = max(err6, close(out, P.zone_sequential_completions(
            i, s, g, backend="numpy"), F64, "phase 6 fleet rows"))
    print(f"[6] sequential completions: chain of {n6}, 16 rows "
          f"{min(lens)}..{max(lens)}, max abs err vs numpy {err6:.3e}")

    # -- phases 7, 9, 10: greedy_generate at full width and depth -----------
    def generation_phase(phase, arch, batch, plen, max_seq, need,
                         logits_atol, f32_atol, extra=None, weight_std=None,
                         overrides=None):
        """The model's 2-layer smoke config in float32 first (kernels
        against plain versions, equal greedy tokens), then the published
        config (with ``overrides``) from seed 0: greedy_generate (launches
        counted), prefill and decode times, peak memory, a profile, and
        the last logits with the kernels against those with the plain
        versions, in the config's dtype (checked at ``logits_atol`` unless
        None) and in the float32 model (float32 activations; checked at
        ``f32_atol`` unless None), and against the float32 model's.
        Prompts are (batch, plen) tokens, or (batch, plen, Cb) for a
        codebook model.  ``weight_std``: every weight matrix N(0,
        weight_std) instead of the reference's fan-in rule.
        ``extra(cfg, params, prompt)``, when given, runs further checks on
        the model (block by block, an image prefill); its result is
        returned as ``block_errs``."""
        def tokens(cfg, b, s):
            cb = (cfg.num_codebooks,) if cfg.num_codebooks > 1 else ()
            return torch.as_tensor(np.random.default_rng(0).integers(
                1, cfg.vocab_size, (b, s) + cb), device=cuda)

        small = get_smoke_config(arch, dtype="float32", kernel_impl="cuda")
        sparams = M.init_params(small, torch.Generator(cuda).manual_seed(0),
                                device=cuda)
        sprompt = tokens(small, 2, 40)
        stoks = greedy_generate(small, sparams, sprompt, steps=8, max_seq=64)
        ptoks = greedy_generate(dataclasses.replace(small,
                                                    kernel_impl="torch"),
                                sparams, sprompt, steps=8, max_seq=64)
        check(torch.equal(stoks, ptoks), f"phase {phase} smoke config: "
              f"tokens {stoks.tolist()} (kernels) vs {ptoks.tolist()} "
              f"(plain)")
        del sparams

        cfg = get_config(arch, **(overrides or {}))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        params = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                               device=cuda, weight_std=weight_std)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        prompt = tokens(cfg, batch, plen)
        K.reset_launch_counts()
        t = time.perf_counter()
        toks = greedy_generate(cfg, params, prompt, steps=16,
                               max_seq=max_seq)
        torch.cuda.synchronize()
        gen_ms = (time.perf_counter() - t) * 1e3
        read_counts(phase, need)
        check(tuple(toks.shape) == (batch, 16) + tuple(prompt.shape[2:]),
              f"phase {phase}: tokens {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"phase {phase}: token out of the vocabulary")
        t = time.perf_counter()
        logits, cache = M.prefill(cfg, params, prompt, max_seq)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        tok = logits[:, -1].argmax(-1)
        step_ms = []
        for i in range(8):
            t = time.perf_counter()
            step_logits, cache = M.decode_step(cfg, params, cache, tok,
                                               plen + i)
            tok = step_logits.argmax(-1)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        step_ms.sort()
        decode_ms = step_ms[len(step_ms) // 2]
        check(torch.equal(tok, toks[:, 8]), f"phase {phase}: decode after "
              f"prefill gave {tok.tolist()}, greedy_generate "
              f"{toks[:, 8].tolist()}")
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        shape = " x ".join(f"{n:,}" for n in prompt.shape)
        for what, fn in ((f"prefill {shape}", lambda: M.prefill(
                              cfg, params, prompt, max_seq)),
                         (f"decode step, batch {batch}", lambda: M.decode_step(
                             cfg, params, cache, tok, plen + 8))):
            brk = device_breakdown(fn)
            if brk is None:
                print(f"[{phase}] {what}: profiler recorded no device time "
                      f"(breakdown not measured)")
                continue
            wall, busy, n, groups, _ = brk
            print(f"[{phase}] {what} under torch.profiler: wall {wall:.1f} "
                  f"ms, {n} device events, kernels {busy:.1f} ms, device "
                  f"idle {max(0.0, 1 - busy / wall):.1%}; " + ", ".join(
                      f"{g} {ms:.2f} ms" for g, ms in groups))
        del cache
        plain, _ = M.prefill(dataclasses.replace(cfg, kernel_impl="torch"),
                             params, prompt, max_seq)
        f32 = dataclasses.replace(cfg, dtype="float32")
        exact, _ = M.prefill(f32, params, prompt, max_seq)
        f32_plain = dataclasses.replace(f32, kernel_impl="torch")
        exact_plain, _ = M.prefill(f32_plain, params, prompt, max_seq)
        # the float32 model's own sensitivity: the first layer norm's scale
        # (1 + w, w = 0 at init) moved by one float32 step
        w = next(p for n, p in params.named_parameters()
                 if n.rsplit(".", 1)[-1] in ("ln", "ln1"))
        with torch.no_grad():
            w.add_(2.0 ** -23)
        nudged, _ = M.prefill(f32_plain, params, prompt, max_seq)
        with torch.no_grad():
            w.sub_(2.0 ** -23)
        nudge = float((nudged - exact_plain).abs().max())
        got = logits[:, -1].cpu().numpy()
        want = plain[:, -1].cpu().numpy()
        got32 = exact[:, -1].cpu().numpy()
        want32 = exact_plain[:, -1].cpu().numpy()
        check(bool(np.isfinite(got).all() and np.isfinite(got32).all())
              and got.shape == want.shape == got32.shape,
              f"phase {phase}: last logits not finite or misshapen")
        err = float(np.abs(got - want).max())
        to_f32 = float(np.abs(got - got32).max())
        plain_f32 = float(np.abs(want - got32).max())
        f32_err = float(np.abs(got32 - want32).max())
        init = ("fan-in init" if weight_std is None
                else f"weights N(0, {weight_std})")
        print(f"[{phase}] {arch}: {M.count_params(cfg):,} {cfg.param_dtype} "
              f"params ({init}), init "
              f"{init_s:.1f} s, greedy_generate {shape} + 16 tokens "
              f"{gen_ms:.1f} ms, prefill {prefill_ms:.1f} ms, decode "
              f"{decode_ms:.2f} ms/token (batch {batch}; median of 8 steps, "
              f"{step_ms[0]:.2f}..{step_ms[-1]:.2f}), peak memory "
              f"{peak_gb:.2f} GB")
        print(f"[{phase}] last logits max |logit| "
              f"{float(np.abs(got).max()):.3f}; kernels vs plain {err:.3e} "
              f"(mean {float(np.abs(got - want).mean()):.3e}, atol "
              f"{logits_atol}); bfloat16 vs float32 model: kernels "
              f"{to_f32:.3e}, plain {plain_f32:.3e}; float32 model, kernels "
              f"vs plain {f32_err:.3e} (atol {f32_atol}); float32 plain "
              f"model with its first norm's scale moved one step "
              f"{nudge:.3e}; tokens {toks[0].tolist()}")
        block_errs = extra(cfg, params, prompt) if extra else None
        if logits_atol is not None:
            close(got, want, dict(rtol=0.0, atol=logits_atol),
                  f"phase {phase} last logits, kernels vs plain")
        if f32_atol is not None:
            close(got32, want32, dict(rtol=0.0, atol=f32_atol),
                  f"phase {phase} float32 last logits, kernels vs plain")
        del params, logits, plain, exact, exact_plain, nudged, step_logits
        torch.cuda.empty_cache()
        return dict(prefill_ms=prefill_ms, decode_ms=decode_ms,
                    peak_gb=peak_gb, logits_err=err, f32_err=f32_err,
                    to_f32=to_f32, plain_f32=plain_f32, nudge=nudge,
                    block_errs=block_errs)

    generation_phase("7", "qwen3-4b", 2, 1024, 2048,
                     ["flash_attention", "rmsnorm"], LOGITS_ATOL, None)

    # -- phase 8: the continuous-batching driver on qwen3-4b -----------------
    K.reset_launch_counts()
    stats = lserve.main(["--arch", "qwen3-4b", "--requests", "16",
                         "--batch", "4", "--max-seq", "128", "--max-new",
                         "32", "--seed", "0"])
    torch.cuda.synchronize()
    read_counts("8", ["rmsnorm"])
    check(stats["done"] == 16, f"phase 8: {stats['done']}/16 requests")
    print(f"[8] serve driver: {stats['done']} requests, {stats['steps']} "
          f"decode steps in {stats['seconds']:.2f} s, "
          f"{stats['tok_per_s']:.1f} tok/s (batch 4), "
          f"{stats['seconds'] / stats['steps'] * 1e3:.2f} ms/step")

    # -- phase 9: greedy_generate on mamba2-370m ------------------------------
    generation_phase("9", "mamba2-370m", 4, 2000, 2048,
                     ["ssd_chunk_scan", "rmsnorm"], None, F32_LOGITS_ATOL)
    # the bfloat16 prefill's SSD launches (one a layer) all took the
    # tensor-core instance
    got9 = phase_counts["9"]
    check(got9["ssd_chunk_scan"] == 48 and got9["ssd_chunk_scan_mma"] == 48,
          f"phase 9: ssd_chunk_scan launches {got9['ssd_chunk_scan']}, "
          f"tensor-core instance {got9['ssd_chunk_scan_mma']} (want 48, 48)")

    # -- phase 10: greedy_generate on recurrentgemma-9b -----------------------
    def attn_half64(cfg, attn, ln, x, pos):
        """x + attention(norm(x)) in float64 from the plain float32 path's
        q, k and v (the float32 block's own accuracy; causal, windowed by
        cfg.window), and the largest |q|, |k|, |v| and |logit|."""
        from repro_torch.models import common as mc
        f64 = torch.float64
        q, k, v = mc.attn_qkv(cfg, attn, mc.rmsnorm(cfg, ln, x), pos)
        bsz, t, hq, dh = q.shape
        rep = hq // k.shape[2]
        core = torch.empty(q.shape, dtype=f64, device=cuda)
        kpos = torch.arange(t, device=cuda)
        top = 0.0
        for b in range(bsz):
            for c0 in range(0, t, 512):
                qc = q[b, c0:c0 + 512].to(f64)                # (c, H, Dh)
                qpos = kpos[c0:c0 + qc.shape[0], None]
                vis = kpos[None] <= qpos
                if cfg.window is not None:
                    vis &= kpos[None] > qpos - cfg.window
                for h in range(hq):
                    kk = k[b, :, h // rep].to(f64)
                    s = ((qc[:, h] @ kk.T) / dh ** 0.5).masked_fill(
                        ~vis, -float("inf"))
                    top = max(top, float(s.abs().masked_fill(~vis, 0).max()))
                    w = torch.softmax(s, -1)
                    core[b, c0:c0 + qc.shape[0], h] = w @ v[b, :, h // rep].to(
                        f64)
        y = x.to(f64) + torch.einsum("bshk,hkd->bsd", core,
                                     attn["wo"].to(f64))
        return y, [float(a.abs().max()) for a in (q, k, v)] + [top]

    def attn_block64(cfg, p, x, pos):
        """recurrentgemma's attention block in float64 (attn_half64, then
        its MLP), and the largest |q|, |k|, |v| and |logit|."""
        f64 = torch.float64
        y, mags = attn_half64(cfg, p["attn"], p["ln"], x, pos)
        z = y * torch.rsqrt(y.pow(2).mean(-1, keepdim=True)
                            + cfg.rms_eps) * (1.0 + p["ln2"].to(f64))
        m = p["mlp"]
        out = y + (torch.nn.functional.silu(z @ m["w_gate"].to(f64))
                   * (z @ m["w_up"].to(f64))) @ m["w_down"].to(f64)
        return out, mags

    def rglru_blocks(cfg, params, prompt):
        """The first four blocks (rec, rec, attention, rec) one by one,
        each given the bfloat16 plain chain's input, with the kernels and
        with the plain versions, held at BF16_BLOCK_TOL: the recurrent
        blocks in bfloat16.  The attention block does not hold at that
        tolerance for any two implementations: the random init's q, k
        and v reach a few hundred and its logits about 3,000, so in
        bfloat16 one rounding step of the attention output (about 2),
        summed through the output projection, exceeds it, and in float32
        a softmax whose two largest logits nearly tie moves with the
        logits' rounding (the plain float32 block is itself about 0.28
        from the float64 one).  So the attention block is held in float32
        against the block computed in float64 from the plain path's q, k
        and v: every element of the kernels' block within the tolerance
        plus the plain versions' largest error.  Its kernels-vs-plain
        differences, in float32 and bfloat16, are printed."""
        from repro_torch.models import common as mc
        from repro_torch.models import rglru as mr
        plain = dataclasses.replace(cfg, kernel_impl="torch")
        f32 = dataclasses.replace(cfg, dtype="float32")
        f32_plain = dataclasses.replace(f32, kernel_impl="torch")
        group = [(f"group 0 b{i}_{kind}", kind, params.groups[0][
            f"b{i}_{kind}"]) for i, kind in enumerate(cfg.block_pattern)]
        kind1 = cfg.block_pattern[0]
        group.append((f"group 1 b0_{kind1}", kind1,
                      params.groups[1][f"b0_{kind1}"]))
        kinds = [k for _, k, _ in group]
        check("rec" in kinds and "attn" in kinds,
              f"phase 10: blocks {kinds}")
        tol = BF16_BLOCK_TOL
        errs = []
        with torch.inference_mode():
            x = mc.embed_tokens(cfg, params.embed, prompt,
                                mc.torch_dtype(cfg.dtype))
            pos = torch.arange(prompt.shape[1], dtype=torch.int32,
                               device=cuda).expand(*prompt.shape)
            for name, kind, p in group:
                if kind == "rec":
                    got, want = (mr.rec_block(c, p, x) for c in (cfg, plain))
                    x = want
                    err = close(got.float().cpu().numpy(),
                                want.float().cpu().numpy(), tol,
                                f"phase 10 {name}, kernels vs plain")
                    print(f"[10] {name} (rec) {tuple(got.shape)} "
                          f"{got.dtype}: kernels vs plain max abs err "
                          f"{err:.3e} (max |x| "
                          f"{float(want.float().abs().max()):.3f}; {tol})")
                    errs.append(err)
                    continue
                got, want = (mr.attn_block(c, p, x.float(), pos)
                             for c in (f32, f32_plain))
                exact, mags = attn_block64(f32_plain, p, x.float(), pos)
                e_plain = float((want.double() - exact).abs().max())
                e_kern = (got.double() - exact).abs()
                excess = float((e_kern - tol["atol"] - tol["rtol"]
                                * exact.abs()).max()) - e_plain
                agree = ((got - want).abs() <= tol["atol"] + tol["rtol"]
                         * want.abs()).all(-1)
                err = float((got - want).abs().max())
                nxt = mr.attn_block(plain, p, x, pos)
                bf16 = mr.attn_block(cfg, p, x, pos)
                print(f"[10] {name} (attn) {tuple(got.shape)} float32: "
                      f"against the float64 block, kernels "
                      f"{float(e_kern.max()):.3e}, plain {e_plain:.3e} "
                      f"(excess over the plain error and {tol}: "
                      f"{excess:.3e}); kernels vs plain {err:.3e}, within "
                      f"{tol} on {int(agree.sum())}/{agree.numel()} tokens; "
                      f"in bfloat16 kernels vs plain "
                      f"{float((bf16 - nxt).abs().max()):.3e} (max |x| "
                      f"{float(nxt.float().abs().max()):.3f}); max |q|, "
                      f"|k|, |v|, |logit| {[round(a, 1) for a in mags]}")
                check(excess <= 0, f"phase 10 {name}: the kernels' float32 "
                                   f"block is {excess:.3e} farther from the "
                                   f"float64 block than the plain versions' "
                                   f"error and {tol} allow")
                errs.append(err)
                x = nxt
        return errs

    generation_phase("10", "recurrentgemma-9b", 2, 3072, 4096,
                     ["linear_recurrence", "flash_attention", "rmsnorm"],
                     None, None, extra=rglru_blocks)
    # the whole model from a better-conditioned init: every weight matrix
    # N(0, 0.02); its bfloat16 last logits held kernels against plain
    res10b = generation_phase("10b", "recurrentgemma-9b", 2, 3072, 4096,
                              ["linear_recurrence", "flash_attention",
                               "rmsnorm"], LOGITS_ATOL, None,
                              weight_std=INIT_STD)
    print(f"[10b] recurrentgemma-9b from N(0, {INIT_STD}): whole-model last "
          f"logits kernels vs plain {res10b['logits_err']:.3e} (bfloat16, "
          f"atol {LOGITS_ATOL}), {res10b['f32_err']:.3e} (float32, not "
          f"held)")

    # -- phase 11: the continuous-batching driver on mamba2-370m -------------
    K.reset_launch_counts()
    stats = lserve.main(["--arch", "mamba2-370m", "--requests", "16",
                         "--batch", "4", "--max-seq", "128", "--max-new",
                         "32", "--seed", "0"])
    torch.cuda.synchronize()
    read_counts("11", ["rmsnorm"])
    check(stats["done"] == 16, f"phase 11: {stats['done']}/16 requests")
    print(f"[11] serve driver: {stats['done']} requests, {stats['steps']} "
          f"decode steps in {stats['seconds']:.2f} s, "
          f"{stats['tok_per_s']:.1f} tok/s (batch 4), "
          f"{stats['seconds'] / stats['steps'] * 1e3:.2f} ms/step")

    # -- phase 12: the exactness matrix on the cuda driver -------------------
    cells = exactness.cells()
    K.reset_launch_counts()
    worst = 0.0
    for cell in cells:
        comp, used, conv = cell.solve("cuda", device=cuda)
        check(cell.program.exact, f"phase 12: {cell.name} is not exact")
        check(conv, f"phase 12: {cell.name} did not converge")
        err = cell.max_rel_err(comp)
        check(err <= cell.tol, f"phase 12: {cell.name} max rel err "
                               f"{err:.3e} over rtol {cell.tol}")
        worst = max(worst, err)
    torch.cuda.synchronize()
    read_counts("12", ["zns_fixpoint"])
    print(f"[12] exactness matrix: {len(cells)} cells (scale "
          f"{exactness.SCALE}) on the cuda driver (the sharded ones on the "
          f"mesh executor), all exact and converged, "
          f"max rel err against the event engine {worst:.3e} (rtol "
          f"{exactness.TOL_JITTER_FREE:g} jitter-free, "
          f"{exactness.TOL_JITTERED:g} jittered)")

    # -- phase 13: the experiment runner ------------------------------------
    fixtures = {}
    for path in sorted(glob.glob(os.path.join(ROOT, "results", "experiments",
                                              "obs*.json"))):
        with open(path) as f:
            data = json.load(f)
        fixtures[data["name"]] = data
    check(len(fixtures) == 15, f"phase 13: {len(fixtures)} fixtures")
    K.reset_launch_counts()
    t = time.perf_counter()
    results13 = runner13.run()
    torch.cuda.synchronize()
    run13_ms = (time.perf_counter() - t) * 1e3
    read_counts("13", ["zns_fixpoint"])
    fres13 = runner13.last_fleet
    launch13 = dict(kfix.zns_fixpoint.last_launch)
    cstats, sstats = fres13.compile_stats, fres13.solve_stats
    check(len(results13) == 15, f"phase 13: {len(results13)} results")
    check(phase_counts["13"]["zns_fixpoint"] == 1,
          f"phase 13: {phase_counts['13']['zns_fixpoint']} fixpoint "
          f"launches for one fleet call")
    check(sstats.driver == "cuda" and sstats.converged,
          f"phase 13: driver {sstats.driver}, converged {sstats.converged}")
    worst13 = 0.0
    for r in results13:
        want = fixtures.get(r.name)
        check(want is not None, f"phase 13: no fixture for {r.name}")
        check(r.passed and r.converged and r.backend == "vectorized",
              f"phase 13: {r.name} passed {r.passed}, converged "
              f"{r.converged}, backend {r.backend}: "
              f"{[str(c) for c in r.checks if not c.ok]}")
        verdicts = [(c.name, bool(c.ok)) for c in r.checks]
        check(verdicts == [(c["name"], c["ok"]) for c in want["checks"]],
              f"phase 13: {r.name} checks {verdicts}")
        check(set(r.metrics) == set(want["metrics"]),
              f"phase 13: {r.name} metric names differ from the fixture")
        for k, v in r.metrics.items():
            w = want["metrics"][k]
            if k == "oracle_max_rel_diff":
                check(abs(v) <= RUNNER_ORACLE_ATOL,
                      f"phase 13: {r.name} {k} = {v:.3e}")
                continue
            if w is None:          # the fixture's non-finite value
                check(not np.isfinite(v), f"phase 13: {r.name} {k} = {v}")
                continue
            rel = abs(v - w) / abs(w) if w else abs(v)
            check(abs(v - w) <= RUNNER_RTOL * abs(w),
                  f"phase 13: {r.name} {k} = {v!r}, fixture {w!r} (rel "
                  f"{rel:.3e} over {RUNNER_RTOL})")
            worst13 = max(worst13, rel)
    # a second run of the same selection: the compiled program is cached
    t = time.perf_counter()
    again = runner13.run()
    torch.cuda.synchronize()
    rerun13_ms = (time.perf_counter() - t) * 1e3
    check([r.metrics for r in again] == [r.metrics for r in results13],
          "phase 13: a second run gave other metrics")
    # the device kernels of one whole run: exactly one fixpoint solve (the
    # most any of 3 profiled runs recorded, as device_ms counts them: a
    # profiled window can miss a kernel), and one launch in each run
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    seen = []
    # three runs, and up to three more while none recorded a device kernel
    while len(seen) < 3 or (len(seen) < 6 and max(seen)[1] == 0):
        before = kfix.zns_fixpoint.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            runner13.run()
            torch.cuda.synchronize()
        check(kfix.zns_fixpoint.launches == before + 1,
              f"phase 13: {kfix.zns_fixpoint.launches - before} fixpoint "
              f"launches in one run")
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("Memcpy", "Memset"))]
        seen.append((sum("fp_solve_kernel" in k for k in names), len(names)))
    n_fp, n_kern = max(seen)
    check(n_fp == 1, f"phase 13: torch.profiler saw (fixpoint kernels, "
                     f"device kernels) {seen} in {len(seen)} runs")
    solve13 = solve_ms(prog13, svc13)
    print(f"[13] experiment runner: {len(results13)}/15 observations passed "
          f"and converged in one fleet call: {cstats.n_devices} members "
          f"({cstats.n_unique} unique), {prog13.n_flat} requests, "
          f"{sstats.n_blocks} blocks, {sstats.sweeps} sweeps, lowering "
          f"{cstats.lowering_ms:.1f} ms, solve {solve13:.4f} ms; run "
          f"{run13_ms:.1f} ms, second (cached) run {rerun13_ms:.1f} ms; "
          f"(fixpoint, all) device kernels in {len(seen)} profiled runs "
          f"{seen}; "
          f"kernel grid {launch13['grid']} of "
          f"{launch13['resident_blocks']} resident blocks, "
          f"{launch13['registers']} registers; worst metric rel diff "
          f"from the fixtures {worst13:.3e}")
    out13 = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", "run", "--all",
         "--out", os.path.join("build", "experiments")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=600)
    tail = [line for line in (out13.stdout + out13.stderr).splitlines()
            if line.strip()][-2:]
    check(out13.returncode == 0, f"phase 13: python -m "
          f"repro_torch.experiments run --all exited with "
          f"{out13.returncode}: {tail}")
    print(f"[13] python -m repro_torch.experiments run --all: exit 0; "
          f"{' '.join(tail)}")
    report["zns_fixpoint"]["runner"] = dict(
        members=cstats.n_devices, unique=cstats.n_unique,
        requests=prog13.n_flat, blocks=sstats.n_blocks,
        sweeps=sstats.sweeps, lowering_ms=cstats.lowering_ms,
        solve_ms=solve13, run_ms=run13_ms, rerun_ms=rerun13_ms,
        device_kernels=n_kern, **launch13)

    # -- phase 14: host scenarios x placement policies on the card -----------
    from repro_torch.host import (HOST_SCENARIO_SPEC, build_scenario,
                                  compare_policies, rank_policies)
    K.reset_launch_counts()
    t = time.perf_counter()
    rows14 = compare_policies(device=cuda)
    torch.cuda.synchronize()
    run14_ms = (time.perf_counter() - t) * 1e3
    read_counts("14", ["zns_fixpoint"])
    check(phase_counts["14"]["zns_fixpoint"] == 1,
          f"phase 14: {phase_counts['14']['zns_fixpoint']} fixpoint "
          f"launches for one fleet call")
    sstats14 = P.last_solve_stats()
    check(sstats14.driver == "cuda" and sstats14.converged,
          f"phase 14: driver {sstats14.driver}, converged "
          f"{sstats14.converged}")
    ev14 = compare_policies(backend="event", device="cpu")
    check(rank_policies(rows14) == rank_policies(ev14),
          f"phase 14: ranking {rank_policies(rows14)} against the event "
          f"backend's {rank_policies(ev14)}")
    worst14 = 0.0
    for a, b in zip(rows14, ev14):
        check((a["scenario"], a["policy"], a["n_requests"])
              == (b["scenario"], b["policy"], b["n_requests"]),
              f"phase 14: row {a['scenario']}/{a['policy']} against "
              f"{b['scenario']}/{b['policy']}")
        for k, v in a.items():
            if isinstance(v, float):
                rel = abs(v - b[k]) / abs(b[k]) if b[k] else abs(v)
                check(abs(v - b[k]) <= RUNNER_RTOL * abs(b[k]),
                      f"phase 14: {a['scenario']}/{a['policy']} {k} = "
                      f"{v!r}, event backend {b[k]!r}")
                worst14 = max(worst14, rel)
    # the profiler can miss every device event of a window: up to 3 tries
    prof14 = None
    for _ in range(3):
        prof14 = prof14 or device_breakdown(
            lambda: compare_policies(device=cuda))
    gold_err = 0.0
    for scen in ("lsm", "circular-log", "cache"):
        with open(os.path.join(ROOT, "tests", "golden",
                               f"{scen}__greedy-open.json")) as f:
            want = json.load(f)
        trace = build_scenario(scen, policy="greedy-open", seed=0,
                               scale=0.5, device=cuda).workload.build()
        h = hashlib.sha256()
        for field in ("op", "zone", "size", "issue", "thread", "qd",
                      "occupancy", "was_finished", "io_ctx"):
            h.update(np.ascontiguousarray(getattr(trace, field)).tobytes())
        check(len(trace) == want["n_requests"]
              and h.hexdigest() == want["workload_sha256"],
              f"phase 14: golden {scen} workload differs")
        res = P.ZnsDevice(HOST_SCENARIO_SPEC, device=cuda).run(
            trace, backend="vectorized", seed=0, jitter=False)
        gold_err = max(gold_err, close(
            res.sim.complete, want["complete_us"], GOLDEN_TOL,
            f"phase 14: golden {scen} on the card's vectorized backend"))
    print(f"[14] compare_policies: {len(rows14)} combinations, "
          f"{sum(r['n_requests'] for r in rows14)} requests in one fleet "
          f"call on the cuda driver ({sstats14.sweeps} sweeps), "
          f"{run14_ms:.1f} ms; rows within {worst14:.3e} of the host event "
          f"backend, ranking {rank_policies(rows14)}; profiled "
          + ("(no device time recorded)" if prof14 is None else
             f"{prof14[0]:.1f} ms wall, {prof14[1]:.4f} ms of device "
             f"kernels in {prof14[2]} device events ({prof14[3]})")
          + f"; the three greedy-open goldens reproduce on the card "
          f"(max abs err {gold_err:.3e})")
    out14 = subprocess.run(
        [sys.executable, "-m", "repro_torch.experiments", "host", "--out",
         os.path.join("build", "host")], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
        text=True, timeout=600)
    tail = [line for line in (out14.stdout + out14.stderr).splitlines()
            if line.strip()][-1:]
    check(out14.returncode == 0, f"phase 14: python -m "
          f"repro_torch.experiments host exited with {out14.returncode}: "
          f"{tail}")
    print(f"[14] python -m repro_torch.experiments host: exit 0; "
          f"{' '.join(tail)}")

    # -- phase 15: the sharded and windowed drivers -------------------------
    wl15 = P.WorkloadSpec()
    for k in range(4):
        kw = dict(n=250_000, size=4 * KiB, qd=0, zone=k * 16, nzones=16,
                  arrival=P.PoissonArrivals(rate_per_s=2e5, seed=k))
        wl15 = wl15.writes(**kw) if k % 2 == 0 else wl15.reads(**kw)
    t = time.perf_counter()
    prog15 = P.compile_fleet_program([wl15.build()], [dev.spec], [dev.lat],
                                     cache=False)
    svc15 = prog15.svc0_flat
    lower15_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    wp15 = pshard.window_program(prog15, window_events=WINDOW_EVENTS)
    window15_ms = (time.perf_counter() - t) * 1e3
    check(wp15.n_windows == 8, f"phase 15: {wp15.n_windows} windows")
    K.reset_launch_counts()
    sharded15 = {label: P.solve_program(prog, svcp, sweeps=budget,
                                        fixpoint="sharded", device=cuda)
                 for label, prog, svcp, budget in (
                     ("phase-13", prog13, svc13, 8),
                     ("phase-5", prog5, svc5, 64))}
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    win15 = pshard.solve_program_windowed(prog15, svc15, sweeps=64,
                                          window_events=WINDOW_EVENTS,
                                          device=cuda)
    torch.cuda.synchronize()
    win15_ms = (time.perf_counter() - t) * 1e3
    win15_mem = torch.cuda.max_memory_allocated() - base_mem
    read_counts("15", ["zns_fixpoint", "zns_fixpoint_sharded"])
    check(phase_counts["15"]["zns_fixpoint_sharded"] == 2,
          f"phase 15: {phase_counts['15']['zns_fixpoint_sharded']} stacked "
          f"launches for two sharded solves")
    check(phase_counts["15"]["zns_fixpoint"] == 8,
          f"phase 15: {phase_counts['15']['zns_fixpoint']} fixpoint "
          f"launches for 8 windows")
    check(win15[2], "phase 15: the windowed solve did not converge")
    for label, prog, svcp, budget in (("phase-13", prog13, svc13, 8),
                                      ("phase-5", prog5, svc5, 64)):
        got, used, conv = sharded15[label]
        want, wused, wconv = P.solve_program(prog, svcp, sweeps=budget,
                                             fixpoint="cuda", device=cuda)
        check(conv and wconv, f"phase 15: {label} sharded converged {conv}")
        err = close(got, want, dict(rtol=1e-12, atol=0.0),
                    f"phase 15: {label} sharded against cuda")
        ms_s = time_ms(lambda: P.solve_program(
            prog, svcp, sweeps=budget, fixpoint="sharded", device=cuda),
            reps=3)
        ms_c = time_ms(lambda: P.solve_program(
            prog, svcp, sweeps=budget, fixpoint="cuda", device=cuda), reps=3)
        print(f"[15] fixpoint='sharded' on {label}'s program "
              f"({pshard.shard_program(prog).n_shards} shards): sweeps "
              f"{used} (cuda {wused}), max abs err against cuda {err:.3e}; "
              f"solve {ms_s:.4f} ms, cuda {ms_c:.4f} ms")
        report["zns_fixpoint_sharded"].setdefault("solve", {})[label] = dict(
            sharded_ms=ms_s, cuda_ms=ms_c, max_abs_err=err)
    base_mem = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    full15 = P.solve_program(prog15, svc15, sweeps=64, fixpoint="cuda",
                             device=cuda)
    torch.cuda.synchronize()
    full15_ms = (time.perf_counter() - t) * 1e3
    full15_mem = torch.cuda.max_memory_allocated() - base_mem
    check(full15[2], "phase 15: the unwindowed solve did not converge")
    err15 = close(win15[0], full15[0], dict(rtol=1e-12, atol=0.0),
                  "phase 15: windowed against the unwindowed cuda solve")
    # the entry is one signature group: a 1-shard plan, which the sharded
    # driver solves with one launch of the single-program kernel (after
    # the unwindowed first call, so that it does not warm that one's
    # caches)
    before = kfix.zns_fixpoint.launches
    one15 = P.solve_program(prog15, svc15, sweeps=64, fixpoint="sharded",
                            device=cuda)
    check(kfix.zns_fixpoint.launches == before + 1,
          f"phase 15: {kfix.zns_fixpoint.launches - before} single-program "
          f"launches for the 1-shard sharded solve")
    check(one15[2] and one15[1] == full15[1],
          f"phase 15: the 1-shard sharded solve took {one15[1]} sweeps "
          f"(cuda {full15[1]}), converged {one15[2]}")
    err_one = close(one15[0], full15[0], dict(rtol=1e-12, atol=0.0),
                    "phase 15: the 1-shard sharded solve against cuda")
    print(f"[15] fixpoint='sharded' on the open-loop entry (1 shard): one "
          f"single-program launch, max abs err against cuda {err_one:.3e}")
    warm_win = time_ms(lambda: pshard.solve_program_windowed(
        prog15, svc15, sweeps=64, window_events=WINDOW_EVENTS, device=cuda),
        reps=3)
    warm_full = time_ms(lambda: P.solve_program(
        prog15, svc15, sweeps=64, fixpoint="cuda", device=cuda), reps=3)
    print(f"[15] windowed open-loop entry: {prog15.n_flat} requests, blocks "
          f"{[b.shape for b in prog15.families]}, lowering "
          f"{lower15_ms:.1f} ms, windowing {window15_ms:.1f} ms, "
          f"{wp15.n_windows} windows of {[len(w.perm) for w in wp15.windows]} "
          f"events, sweeps {win15[1]} (unwindowed {full15[1]}), max abs err "
          f"against the unwindowed cuda solve {err15:.3e}; first call "
          f"{win15_ms:.1f} ms and {win15_mem / 1e6:.1f} MB of peak device "
          f"memory (unwindowed {full15_ms:.1f} ms, {full15_mem / 1e6:.1f} "
          f"MB); warm {warm_win:.3f} ms (unwindowed {warm_full:.3f} ms)")
    report["zns_fixpoint"]["windowed"] = dict(
        requests=prog15.n_flat, windows=wp15.n_windows,
        first_ms=win15_ms, peak_bytes=win15_mem, warm_ms=warm_win,
        full_first_ms=full15_ms, full_peak_bytes=full15_mem,
        full_warm_ms=warm_full, max_abs_err=err15)

    # -- phase 16: qwen2-moe-a2.7b at full width and depth --------------------
    from repro_torch.models import common as mc
    from repro_torch.models import moe as mmoe

    def routes_of(cfg, params, prompt, max_seq):
        """Every layer's (T, k) expert choices in one prefill."""
        for layer in params.layers:
            layer.routing = []
        M.prefill(cfg, params, prompt, max_seq)
        out = [layer.routing[0].expert_idx for layer in params.layers]
        for layer in params.layers:
            layer.routing = None
        return out

    def rerouted(a, b, n_experts):
        """Per layer, the (token, expert) choices of ``a`` that ``b`` does
        not make."""
        out = []
        for x, y in zip(a, b):
            ox = torch.zeros(x.shape[0], n_experts, device=cuda).scatter_(
                1, x, 1.0)
            oy = torch.zeros(y.shape[0], n_experts, device=cuda).scatter_(
                1, y, 1.0)
            out.append(int((ox * (1 - oy)).sum()))
        return out

    def moe_reference(cfg, p, hn):
        """One layer's routed experts and shared expert in float32, expert
        by expert on its own tokens (no sort, no buffer): the top k of the
        router's probabilities, renormalised, and each expert's first
        ``capacity`` picks in token order kept (the reference's drops)."""
        t, d = hn.shape[0] * hn.shape[1], hn.shape[-1]
        x = hn.reshape(t, d).float()
        probs = torch.softmax(x @ p["router"].float(), -1)
        gate, idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
        gate = gate / gate.sum(-1, keepdim=True)
        cap = mmoe._capacity(cfg, t)
        y = torch.zeros(t, d, device=cuda)
        for e in range(cfg.moe_num_experts):
            tok, j = torch.nonzero(idx == e, as_tuple=True)
            tok, j = tok[:cap], j[:cap]
            h = x[tok]
            out = (F.silu(h @ p["w_gate"][e].float())
                   * (h @ p["w_up"][e].float())) @ p["w_down"][e].float()
            y.index_add_(0, tok, out * gate[tok, j, None])
        sh = p["shared"]
        y += (F.silu(x @ sh["w_gate"].float()) * (x @ sh["w_up"].float())) \
            @ sh["w_down"].float()
        return y.reshape(hn.shape)

    def moe_layers(cfg, params, prompt):
        """The routing of the whole prefill with the kernels against the
        plain versions (choices that differ, layer by layer, in bfloat16
        and in float32), then the first MOE_LAYERS layers one by one, each
        given the bfloat16 plain chain's input.  The attention half
        (x + attention(norm(x))), as phase 10's attention block: the
        random init's logits reach the hundreds (no q/k-norm), so a
        near-tied softmax moves it past BF16_BLOCK_TOL for any two
        implementations; it is held in float32 against the float64 half,
        within the tolerance plus the plain versions' own largest error
        (its kernels-vs-plain differences are printed).  The FFN half's
        norm at BF16_BLOCK_TOL (its outputs reach several units, where one
        bfloat16 step exceeds the RMSNorm test's atol); the MoE block (routed
        experts and shared expert) on the plain norm's output against a
        float32 expert-by-expert computation at BF16_BLOCK_TOL; and the
        MoE block on each run's own norm output, kernels against plain, at
        BF16_BLOCK_TOL on every token that both route alike (a token whose
        norm output rounds otherwise may pick another expert: those are
        counted)."""
        plain = dataclasses.replace(cfg, kernel_impl="torch")
        f32 = dataclasses.replace(cfg, dtype="float32")
        f32_plain = dataclasses.replace(f32, kernel_impl="torch")
        n_exp, k = cfg.moe_num_experts, cfg.moe_top_k
        max_seq = 2 * prompt.shape[1]
        bf = rerouted(routes_of(cfg, params, prompt, max_seq),
                      routes_of(plain, params, prompt, max_seq), n_exp)
        fl = rerouted(routes_of(f32, params, prompt, max_seq),
                      routes_of(f32_plain, params, prompt, max_seq), n_exp)
        print(f"[16] routing, kernels vs plain: of the {prompt.numel() * k} "
              f"(token, expert) choices of each layer of the prefill, "
              f"{sum(bf)} differ in all in bfloat16 (by layer {bf}) and "
              f"{sum(fl)} in float32 ({fl})")
        tol = BF16_BLOCK_TOL
        errs = dict(flips_bf16=bf, flips_f32=fl, layers=[])
        with torch.inference_mode():
            x = mc.embed_tokens(cfg, params.embed, prompt,
                                mc.torch_dtype(cfg.dtype))
            pos = torch.arange(prompt.shape[1], dtype=torch.int32,
                               device=cuda).expand(*prompt.shape)
            for i in range(MOE_LAYERS):
                layer = params.layers[i]

                def attn_half(c, y):
                    return y + mc.attention(c, layer.attn, mc.rmsnorm(
                        c, layer.ln1, y), pos)

                got, want = (attn_half(c, x.float()) for c in (f32, f32_plain))
                exact, mags = attn_half64(f32_plain, layer.attn, layer.ln1,
                                          x.float(), pos)
                e_plain = float((want.double() - exact).abs().max())
                e_kern = float((got.double() - exact).abs().max())
                excess = float(((got.double() - exact).abs() - tol["atol"]
                                - tol["rtol"] * exact.abs()).max()) - e_plain
                check(excess <= 0, f"phase 16 layer {i}: the kernels' float32 "
                                   f"attention half is {excess:.3e} farther "
                                   f"from the float64 one than the plain "
                                   f"versions' error and {tol} allow")
                e_attn = float((got - want).abs().max())
                want = attn_half(plain, x)
                e_bf16 = float((attn_half(cfg, x) - want).abs().max())
                hk, hp = (mc.rmsnorm(c, layer.ln2, want) for c in (cfg, plain))
                e_norm = close(hk.float().cpu().numpy(),
                               hp.float().cpu().numpy(), tol,
                               f"phase 16 layer {i} FFN norm, kernels vs "
                               f"plain")
                layer.routing = []
                yk, _ = layer.ffn(cfg, hk)
                yp, _ = layer.ffn(plain, hp)
                rk, rp = layer.routing
                layer.routing = None
                ref = moe_reference(cfg, layer.moe, hp)
                e_ref = close(yp.float().cpu().numpy(), ref.cpu().numpy(), tol,
                              f"phase 16 layer {i} MoE block against the "
                              f"float32 expert-by-expert computation")
                same = (torch.sort(rk.expert_idx, -1).values
                        == torch.sort(rp.expert_idx, -1).values).all(-1)
                e_moe = close(yk.reshape(-1, yk.shape[-1])[same].float().cpu()
                              .numpy(),
                              yp.reshape(-1, yp.shape[-1])[same].float().cpu()
                              .numpy(), tol,
                              f"phase 16 layer {i} MoE block, kernels vs "
                              f"plain, on the tokens routed alike")
                drops = int((~rp.valid).sum())
                print(f"[16] layer {i} from the plain chain's input: "
                      f"attention half in float32 against the float64 one: "
                      f"kernels {e_kern:.3e}, plain {e_plain:.3e} (excess "
                      f"over the plain error and {tol}: {excess:.3e}); "
                      f"kernels vs plain "
                      f"{e_attn:.3e} (float32), {e_bf16:.3e} (bfloat16; max "
                      f"|q|, |k|, |v|, |logit| "
                      f"{[round(a, 1) for a in mags]}); FFN "
                      f"norm {e_norm:.3e}; MoE block against the float32 "
                      f"expert-by-expert computation {e_ref:.3e} (capacity "
                      f"{rp.cap}, {drops} of {rp.valid.numel()} picks "
                      f"dropped); kernels vs plain {e_moe:.3e} on "
                      f"{int(same.sum())}/{same.numel()} tokens routed alike "
                      f"({int((~same).sum())} rerouted by the norm's "
                      f"rounding; {tol})")
                errs["layers"].append(dict(attn=e_attn, attn_bf16=e_bf16,
                                           attn_excess=excess, norm=e_norm,
                                           moe_vs_f32=e_ref, moe=e_moe,
                                           rerouted=int((~same).sum()),
                                           drops=drops))
                x = want + yp
        return errs

    res16 = generation_phase("16", "qwen2-moe-a2.7b", 2, 1024, 2048,
                             ["flash_attention", "rmsnorm"], None, None,
                             extra=moe_layers)
    # The whole model's last logits are not held (logits_atol and f32_atol
    # None above): routing is discrete, and one choice that differs (4 of
    # 8,192 at the first layer in bfloat16) reroutes later tokens layer
    # after layer, in float32 too.  The first layers are held one by one in
    # moe_layers, and the bfloat16 attention kernel at this model's shape
    # on random inputs in phase 2 ("moe").
    flips16 = res16["block_errs"]
    print(f"[16] whole-model last logits kernels vs plain "
          f"{res16['logits_err']:.3e} (bfloat16), {res16['f32_err']:.3e} "
          f"(float32), not held; (token, expert) choices that differ "
          f"{sum(flips16['flips_bf16'])} / {sum(flips16['flips_f32'])}")
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    stats = lserve.main(["--arch", "qwen2-moe-a2.7b", "--requests", "16",
                         "--batch", "4", "--max-seq", "128", "--max-new",
                         "32", "--seed", "0"])
    torch.cuda.synchronize()
    read_counts("16 serve", ["rmsnorm"])
    check(stats["done"] == 16, f"phase 16: {stats['done']}/16 requests")
    print(f"[16] serve driver on qwen2-moe-a2.7b: {stats['done']} requests, "
          f"{stats['steps']} decode steps in {stats['seconds']:.2f} s, "
          f"{stats['tok_per_s']:.1f} tok/s (batch 4), "
          f"{stats['seconds'] / stats['steps'] * 1e3:.2f} ms/step, peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    torch.cuda.empty_cache()

    # -- phase 17: the ZNS checkpoint store ---------------------------------
    from repro_torch.core import MiB
    from repro_torch.core.calibration import PEAK_WRITE_BW_MIBS
    from repro_torch.runtime import ZnsHostDevice, ZonedCheckpointStore
    from repro_torch.utils import tree_bytes, tree_leaves
    shard17 = 4 * 1024 * MiB
    K.reset_launch_counts()
    for name, kw in (("R2: 1 MiB appends @ QD4", dict(stripe_bytes=1 * MiB,
                                                      append_qd=4)),
                     ("4 KiB appends @ QD1", dict(stripe_bytes=4 * KiB,
                                                   append_qd=1)),
                     ("64 KiB appends @ QD4", dict(stripe_bytes=64 * KiB,
                                                    append_qd=4)),
                     ("4 MiB appends @ QD4", dict(stripe_bytes=4 * MiB,
                                                   append_qd=4))):
        before = kscan.zns_event_scan.launches
        t = time.perf_counter()
        sec, n = ZnsHostDevice(0, device=cuda, **kw).simulate_payload_write(
            shard17)
        call_ms = (time.perf_counter() - t) * 1e3
        check(kscan.zns_event_scan.launches == before + 1,
              f"phase 17 {name}: {kscan.zns_event_scan.launches - before} "
              f"scan launches")
        sec_cpu, n_cpu = ZnsHostDevice(0, device="cpu",
                                       **kw).simulate_payload_write(shard17)
        rel = abs(sec - sec_cpu) / sec_cpu
        check(n == n_cpu and rel <= STORE_RTOL,
              f"phase 17 {name}: {sec!r} s, {n} appends on the card, "
              f"{sec_cpu!r} s, {n_cpu} on the CPU")
        print(f"[17] {name}, 4 GiB: {n} appends in one scan launch, "
              f"modeled {sec!r} s ({shard17 / sec / MiB:.1f} MiB/s); the "
              f"CPU's {sec_cpu!r} s (rel diff {rel:.3e}); call "
              f"{call_ms:.2f} ms")
    dev17 = ZnsHostDevice(0, device=cuda)
    entries = dev17.plan(shard17)
    dev17.apply_writes(entries)
    full = [e.zone for e in entries if dev17.zm.state(e.zone).name == "FULL"]
    dev17.schedule_reset(full)
    gc17 = dev17.run_gc(concurrent_io=True)
    fill17 = shard17 / (PEAK_WRITE_BW_MIBS * MiB)
    print(f"[17] R5: reset {len(full)} zones under I/O: {gc17 * 1e3:.3f} ms "
          f"({gc17 / fill17:.2%} of the fill time)")
    # the store: mamba2-370m's full-size parameters on 4 hosts
    cfg17 = get_config("mamba2-370m")
    params17 = M.init_params(cfg17, torch.Generator(cuda).manual_seed(0),
                             device=cuda)
    tree17 = params17.param_tree()
    del params17
    root17 = os.path.join(ROOT, "build", "chip_smoke_store")
    shutil.rmtree(root17, ignore_errors=True)
    store17 = ZonedCheckpointStore(os.path.join(root17, "cuda"), n_hosts=4,
                                   device=cuda)
    before = (kscan.zns_event_scan_batched.launches,
              kscan.zns_event_scan.launches)
    t = time.perf_counter()
    saved17 = store17.save(1, tree17)
    save17_s = time.perf_counter() - t
    check((kscan.zns_event_scan_batched.launches,
           kscan.zns_event_scan.launches) == (before[0] + 1, before[1]),
          f"phase 17: save launched the batched scan "
          f"{kscan.zns_event_scan_batched.launches - before[0]} and the "
          f"scan {kscan.zns_event_scan.launches - before[1]} times")
    read_counts("17", ["zns_event_scan", "zns_event_scan_batched"])
    man17 = saved17["manifest"]
    cpu17 = ZonedCheckpointStore(os.path.join(root17, "cpu"), n_hosts=4,
                                 device="cpu").save(1, tree17)["manifest"]
    check(man17["hosts"] == cpu17["hosts"]
          and man17["nleaves"] == cpu17["nleaves"],
          "phase 17: the manifest's hosts (bytes, zones, sha256) differ "
          "from the CPU save's")
    rel17 = max(abs(a - b) / b for a, b in zip(
        man17["modeled_host_seconds"], cpu17["modeled_host_seconds"]))
    check(rel17 <= STORE_RTOL, f"phase 17: modeled seconds "
          f"{man17['modeled_host_seconds']} against the CPU's "
          f"{cpu17['modeled_host_seconds']}")
    t = time.perf_counter()
    restored17, _ = store17.restore(1, tree17)
    restore17_s = time.perf_counter() - t
    for got, want in zip(tree_leaves(restored17), tree_leaves(tree17)):
        check(got.tobytes() == want.cpu().numpy().tobytes(),
              "phase 17: a restored leaf differs from the saved one")
    store17.save(2, tree17)
    gc17_s = store17.gc(keep_last=1)
    check(sorted(os.listdir(store17.root)) == ["step_00000002"]
          and store17.latest_step() == 2,
          f"phase 17: after gc {sorted(os.listdir(store17.root))}")
    shutil.rmtree(root17)
    print(f"[17] ZonedCheckpointStore(n_hosts=4): mamba2-370m, "
          f"{tree_bytes(tree17) / 1e9:.3f} GB in "
          f"{len(tree_leaves(tree17))} leaves; save {save17_s:.2f} s (one "
          f"batched scan launch; {[h['bytes'] for h in man17['hosts'].values()]} "
          f"bytes, {sum(len(h['zones']) for h in man17['hosts'].values())} "
          f"zone extents), modeled wall {saved17['wall_seconds']!r} s, host "
          f"seconds equal to the CPU save's within {rel17:.3e}, manifest "
          f"(bytes, zones, sha256) equal; restore {restore17_s:.2f} s, bit "
          f"for bit; gc(keep_last=1) after a second save: modeled "
          f"{gc17_s * 1e3:.3f} ms of resets")
    del tree17, restored17
    torch.cuda.empty_cache()


    # -- phase 18: training tinyllama-1.1b at full size ----------------------
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch import train as ltrain
    from repro_torch.models import common as mc
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step
    cfg18 = get_config("tinyllama-1.1b")
    L18 = cfg18.num_layers
    runs18 = mc.layer_forward_runs(cfg18, L18)
    # a step's launches: every layer forward (and recompute) runs its two
    # norms and its attention; the final norm runs once; each backward once
    per_step18 = {"rmsnorm": 2 * runs18 + 1, "rmsnorm_bwd": 2 * L18 + 1,
                  "flash_attention": runs18, "flash_attention_bwd": L18}
    train_args = ["--arch", "tinyllama-1.1b", "--batch", "4", "--seq-len",
                  "2048", "--lr", "3e-3", "--warmup", "2", "--log-every",
                  "1", "--init-std", str(INIT_STD)]
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res18 = ltrain.main(train_args + ["--steps", "8", "--seed", "0"])
    torch.cuda.synchronize()
    wall18 = time.perf_counter() - t
    peak18 = torch.cuda.max_memory_allocated() / 1e9
    read_counts("18", list(per_step18))
    got18 = phase_counts["18"]
    for k, v in got18.items():
        want = 8 * per_step18.get(k, 0)
        check(v == want, f"phase 18: {k} launched {v} times in 8 steps, "
                         f"want {want} ({per_step18} a step)")
    losses18, grad_norms18 = res18["losses"], res18["grad_norms"]
    check(len(losses18) == 8 and bool(np.isfinite(losses18).all()),
          f"phase 18: losses {losses18}")
    check(np.mean(losses18[-2:]) < np.mean(losses18[:2]),
          f"phase 18: the loss did not fall: {losses18}")
    state18 = res18["state"]
    step18 = make_train_step(cfg18, AdamWConfig(lr=3e-3, warmup_steps=2,
                                                total_steps=8))
    data18 = TokenPipeline(DataConfig(cfg18.vocab_size, 2048, 4))
    batch18 = data18.batch_at(8)
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state18, _ = step18(state18, batch18)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    brk = device_breakdown(lambda: step18(state18, batch18))
    check(brk is not None, "phase 18: torch.profiler recorded no device time")
    wall_p, busy, nev, groups, nk18 = brk
    names = dict(groups)
    for g in ("flash_attention", "flash_attention_bwd", "rmsnorm",
              "rmsnorm_bwd"):
        check(names.get(g, 0.0) > 0, f"phase 18: the profiler saw no "
                                     f"{g} kernel in a step")
    tok_s = 4 * 2048 / (min(step_ms) / 1e3)
    attn_share = names["flash_attention_bwd"] / busy
    print(f"[18] tinyllama-1.1b at full size ({M.count_params(cfg18) / 1e9:.3f}"
          f"e9 float32 parameters from seed 0, weights N(0, {INIT_STD}), "
          f"bfloat16 activations, remat full, 4 x 2,048 tokens): 8 steps through launch.train in {wall18:.2f} s, "
          f"losses {[round(x, 4) for x in losses18]}; step "
          f"{min(step_ms):.1f} ms ({step_ms}), {tok_s:.0f} tokens/s, peak "
          f"memory {peak18:.2f} GB; launches a step {per_step18} "
          f"({runs18} layer forwards a step)")
    print(f"[18] one step under torch.profiler: wall {wall_p:.1f} ms, {nev} "
          f"device events, kernels {busy:.1f} ms, device idle "
          f"{max(0.0, 1 - busy / wall_p):.1%}, attention backward "
          f"{attn_share:.1%} of the kernels' time; " + ", ".join(
              f"{g} {ms:.2f} ms" for g, ms in groups)
          + f"; the RMSNorm backward's group {nk18['rmsnorm_bwd']} device "
            f"kernels ({per_step18['rmsnorm_bwd']} calls, two kernels a "
            f"call)")
    report18 = dict(step_ms=min(step_ms), tokens_per_s=tok_s, peak_gb=peak18,
                    losses=losses18, idle=max(0.0, 1 - busy / wall_p),
                    attn_bwd_share=attn_share, groups=groups)
    # what phase 26a's dry run of this step is held against
    p18 = dict(batch=4, seq=2048, step_ms=min(step_ms),
               peak_bytes=peak18 * 1e9,
               batch_bytes=sum(torch.as_tensor(v).nbytes
                               for v in batch18.values()),
               leaves={path: leaf.nbytes for name, tree in (
                   ("params", state18.params.param_tree()),
                   ("m", state18.opt["m"]), ("v", state18.opt["v"]))
                   for path, leaf in _leaf_paths(tree, name)})
    del res18, state18, step18
    torch.cuda.empty_cache()

    # gradients on the first step: kernels against plain versions, float32,
    # each held against a float64 plain step
    gen18 = torch.Generator(cuda).manual_seed(0)
    base18 = M.init_params(cfg18, gen18, device=cuda, weight_std=INIT_STD)
    tree18 = base18.param_tree()
    first18 = {"tokens": torch.as_tensor(data18.batch_at(0)["tokens"],
                                         device=cuda)}

    def first_step_grads(cfg, tree, batch):
        """(loss, gradient tree) of one backward of the model on the
        parameter tree ``tree``."""
        model = {"ssm": M.Mamba2, "hybrid": M.RecurrentGemma}.get(
            cfg.family, M.Transformer)
        params = model(cfg, tree)
        params.requires_grad_(True)
        g = M.bind_grads(cfg, params)
        loss, _ = M.loss_fn(cfg, params, batch)
        loss.backward()
        for p in params.parameters():
            p.grad = None
        return float(loss), g

    def grads18(cfg, tree):
        return first_step_grads(cfg, tree, first18)

    def tree_as(tree, dtype):
        return {k: tree_as(v, dtype) if isinstance(v, dict) else v.to(dtype)
                for k, v in tree.items()}

    f32_18 = dataclasses.replace(cfg18, dtype="float32")
    K.reset_launch_counts()
    l_k, g_k = grads18(f32_18, tree18)
    check(kfa.flash_attention_bwd.launches == L18
          and krms.rmsnorm_bwd.launches == 2 * L18 + 1,
          "phase 18: the float32 kernel step did not run the backward "
          "kernels")
    l_p, g_p = grads18(dataclasses.replace(f32_18, kernel_impl="torch"),
                       tree18)
    check(kfa.flash_attention_bwd.launches == L18,
          "phase 18: the plain step launched a kernel")
    f64_18 = dataclasses.replace(cfg18, dtype="float64",
                                 param_dtype="float64", kernel_impl="torch")
    torch.cuda.reset_peak_memory_stats()
    l_64, g_64 = grads18(f64_18, tree_as(tree18, torch.float64))
    peak64 = torch.cuda.max_memory_allocated() / 1e9
    worst, excess_max = [], -1.0
    paths18 = [p for p, _ in mc.spec_leaves(M.model_spec(cfg18))]
    for path, gk, gp, g64 in zip(paths18, tree_leaves(g_k), tree_leaves(g_p),
                                 tree_leaves(g_64)):
        scale = float(g64.abs().max())
        e_k = float((gk.double() - g64).abs().max())
        e_p = float((gp.double() - g64).abs().max())
        excess = e_k - e_p - GRAD_F64_FRAC * scale
        excess_max = max(excess_max, excess / max(scale, 1e-30))
        worst.append((e_k / max(scale, 1e-30), e_p / max(scale, 1e-30),
                      "/".join(path)))
        check(excess <= 0, f"phase 18: gradient {'/'.join(path)}: the "
                           f"kernels' float32 error to float64 {e_k:.3e} "
                           f"exceeds the plain float32 error {e_p:.3e} plus "
                           f"{GRAD_F64_FRAC} of its scale {scale:.3e}")
    worst.sort(reverse=True)
    print(f"[18] first-step gradients, full width and depth, 4 x 2,048 "
          f"tokens: loss kernels {l_k!r}, plain {l_p!r}, float64 {l_64!r}; "
          f"every leaf's float32 error to the float64 step (relative to "
          f"its largest magnitude) within the plain float32 step's plus "
          f"{GRAD_F64_FRAC}; largest kernels / plain: " + "; ".join(
              f"{p} {a:.2e} / {b:.2e}" for a, b, p in worst[:4])
          + f"; peak of the float64 step {peak64:.2f} GB")
    del g_p, g_64
    torch.cuda.empty_cache()
    l_kb, g_kb = grads18(cfg18, tree18)
    l_pb, g_pb = grads18(dataclasses.replace(cfg18, kernel_impl="torch"),
                         tree18)
    gaps = sorted(((float((a - b).norm() / b.norm().clamp_min(1e-30)),
                    "/".join(p)) for p, a, b in zip(
                        paths18, tree_leaves(g_kb), tree_leaves(g_pb))),
                  reverse=True)
    print(f"[18] bfloat16 first-step gradients, kernels vs plain: loss "
          f"{l_kb!r} vs {l_pb!r}; every leaf's relative gap within "
          f"{BF16_GRAD_REL}; largest " +
          "; ".join(f"{p} {g:.2e}" for g, p in gaps[:4]))
    for g, p in gaps:
        check(np.isfinite(g) and g <= BF16_GRAD_REL,
              f"phase 18: bfloat16 gradient {p}: relative gap {g:.3e} "
              f"between kernels and plain versions exceeds {BF16_GRAD_REL}")
    report18["grad_excess"] = excess_max
    report18["bf16_grad_gap"] = gaps[0][0]
    del g_k, g_kb, g_pb, base18, tree18
    torch.cuda.empty_cache()

    # restart: full width, 2 layers; checkpoint at step 3 into the ZNS
    # store, restore into a fresh state, replay steps 3-5
    root18 = os.path.join(ROOT, "build", "chip_smoke_train")
    shutil.rmtree(root18, ignore_errors=True)
    two = train_args + ["--d-model", "2048", "--d-ff", "5632", "--layers",
                        "2"]
    whole = ltrain.main(two + ["--steps", "6", "--seed", "0"])
    K.reset_launch_counts()
    first = ltrain.main(two + ["--steps", "3", "--seed", "0", "--ckpt-dir",
                               root18, "--ckpt-every", "3"])
    check(kscan.zns_event_scan_batched.launches == 1
          and kscan.zns_event_scan.launches == 0,
          f"phase 18: the save launched the batched scan "
          f"{kscan.zns_event_scan_batched.launches} and the scan "
          f"{kscan.zns_event_scan.launches} times (want 1 and 0)")
    read_counts("18 restart", ["zns_event_scan_batched",
                               "flash_attention_bwd", "rmsnorm_bwd"])
    resumed = ltrain.main(two + ["--steps", "6", "--seed", "99",
                                 "--ckpt-dir", root18, "--ckpt-every",
                                 "100"])
    check(resumed["steps"] == 3 and resumed["state"].step == 6,
          f"phase 18: the restored run took {resumed['steps']} steps to "
          f"step {resumed['state'].step}")
    equal = [torch.equal(a, b) for a, b in zip(
        tree_leaves(whole["state"].tree()), tree_leaves(
            resumed["state"].tree())) if isinstance(a, torch.Tensor)]
    check(all(equal), f"phase 18: {equal.count(False)} of {len(equal)} "
                      f"leaves of the restored run differ from the "
                      f"uninterrupted run's")
    nbytes18 = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(root18) for f in fs)
    print(f"[18] restart at full width, 2 layers: checkpoint at step 3 "
          f"({nbytes18 / 1e9:.2f} GB on disk, one batched scan launch), "
          f"restored into a fresh state (seed 99), steps 3-5 replayed: "
          f"params, m and v ({len(equal)} leaves) equal the uninterrupted "
          f"run's bit for bit; losses {[round(x, 4) for x in whole['losses']]}"
          f" vs {[round(x, 4) for x in first['losses'] + resumed['losses']]}")
    shutil.rmtree(root18)
    del whole, first, resumed
    torch.cuda.empty_cache()
    report["flash_attention_bwd"]["training"] = report18

    # -- phase 19: the cluster tier on the card ------------------------------
    from repro_torch import cluster as C
    from repro_torch.cluster import capacity as ccap
    from repro_torch.cluster import compiler as ccomp
    # every solve of the tier goes through solve_program (compile_graph's
    # bootstrap, refinements and warm repairs, plan_capacity's fleet
    # solve): count the calls, the time inside them (it returns host
    # arrays, so that time holds the upload, the launch and the copy
    # back), and each solve's family blocks x sweeps
    solves19 = {"n": 0, "s": 0.0, "block_sweeps": 0, "sweeps": []}
    real_solve = ccomp.solve_program

    def counted_solve(*a, **kw):
        t = time.perf_counter()
        try:
            return real_solve(*a, **kw)
        finally:
            st = P.last_solve_stats()
            solves19["n"] += 1
            solves19["s"] += time.perf_counter() - t
            solves19["block_sweeps"] += st.n_blocks * st.sweeps
            solves19["sweeps"].append(st.sweeps)

    def reset_solves19():
        solves19.update(n=0, s=0.0, block_sweeps=0, sweeps=[])
    ccomp.solve_program = ccap.solve_program = counted_solve
    configs19 = [C.ClusterConfig(C.erasure(2, 1), "round-robin"),
                 C.ClusterConfig(C.replication(2, 2), "hashed"),
                 C.ClusterConfig(C.erasure(4, 2), "strided"),
                 C.ClusterConfig(C.erasure(3, 1), "grouped")]
    spec19 = C.ClusterSpec(n_gateways=4, n_servers=16)
    wl19 = C.ClusterWorkload(n_users=8, ops_per_user=6,
                             object_bytes=1 << 20, get_fraction=0.5, seed=0)
    kw19 = dict(base_spec=spec19, workload=wl19, slo_us=10_000.0,
                degraded=True)
    calls19 = {}

    def plan19(name, device, **kw):
        """One plan_capacity call; its wall, solves and solve time."""
        reset_solves19()
        K.reset_launch_counts()
        t = time.perf_counter()
        out = C.plan_capacity(configs19, [4, 8], device=device, **kw19,
                              **kw)
        wall = time.perf_counter() - t
        sw = sorted(solves19["sweeps"])
        calls19[name] = c = dict(wall_s=wall, solve_s=solves19["s"],
                                 host_s=wall - solves19["s"],
                                 solves=solves19["n"], sweeps=sum(sw),
                                 median_sweeps=sw[len(sw) // 2],
                                 max_sweeps=sw[-1],
                                 block_sweeps=solves19["block_sweeps"])
        if device is cuda:
            read_counts(f"19 {name}", ["zns_fixpoint"])
            got = phase_counts[f"19 {name}"]
            c["launches"] = got["zns_fixpoint"]
            check(got["zns_fixpoint"] == solves19["n"],
                  f"phase 19 {name}: {got['zns_fixpoint']} fixpoint "
                  f"launches for {solves19['n']} solves")
            check(sum(v for k, v in got.items() if k != "zns_fixpoint")
                  == 0, f"phase 19 {name}: other kernels launched: {got}")
            check(P.last_solve_stats().driver == "cuda",
                  f"phase 19 {name}: driver {P.last_solve_stats().driver}")
        print(f"[19] {name}: {out.n_programs} programs, {out.n_events} "
              f"events, fleet solve {out.sweeps_used} sweeps; wall "
              f"{wall:.3f} s = host {c['host_s']:.3f} s + "
              f"{c['solves']} solve_program calls {c['solve_s']:.3f} s"
              + (f", {c['launches']} fixpoint launches"
                 if "launches" in c else "") + f" (device={device}); "
              f"{c['sweeps']} sweeps in all (median {c['median_sweeps']}, "
              f"most {c['max_sweeps']} a solve), {c['block_sweeps']} "
              f"family blocks x sweeps")
        check(out.converged and all(p.converged for cv in out.curves
                                    for p in cv.points),
              f"phase 19 {name}: not converged")
        check(out.order_unstable == (),
              f"phase 19 {name}: order-unstable {out.order_unstable}")
        check(all(e.program.order_stable and e.converged
                  for e in out.compiled),
              f"phase 19 {name}: an entry is not order-stable")
        return out

    def same_entries19(got, want, what):
        """Programs, families and pop orders exactly; completions (each
        entry's and the fleet solve's) to rtol 1e-12."""
        check(len(got.compiled) == len(want.compiled),
              f"phase 19 {what}: {len(got.compiled)} entries against "
              f"{len(want.compiled)}")
        for i, (g, w) in enumerate(zip(got.compiled, want.compiled)):
            gp, wp = g.program, w.program
            check((gp.n_flat, gp.refine_used, gp.order_stable)
                  == (wp.n_flat, wp.refine_used, wp.order_stable)
                  and len(gp.families) == len(wp.families)
                  and all(a.label == b.label
                          and np.array_equal(a.gidx, b.gidx)
                          and np.array_equal(a.heads, b.heads)
                          for a, b in zip(gp.families, wp.families)),
                  f"phase 19 {what}: entry {i}'s program differs")
            check(len(g.fifo_chains) == len(w.fifo_chains)
                  and all(len(a) == len(b) and all(
                      np.array_equal(x, y) for x, y in zip(a, b))
                      for a, b in zip(g.fifo_chains, w.fifo_chains)),
                  f"phase 19 {what}: entry {i}'s FIFO pop orders differ")
            close(g.comp, w.comp, dict(rtol=1e-12, atol=0.0),
                  f"phase 19 {what}: entry {i}'s completions")
        return close(got.comp, want.comp, dict(rtol=1e-12, atol=0.0),
                     f"phase 19 {what}: fleet completions")

    def same_curves19(got, want, what):
        """Equal reports (warm telemetry aside): floats to rtol 1e-12,
        the rest exactly; returns the largest relative difference."""
        a, b = got.to_json(), want.to_json()
        for k in ("warm_hits", "warm_attempts"):
            a.pop(k), b.pop(k)
        worst = [0.0]

        def walk(x, y, path):
            if isinstance(y, dict):
                check(set(x) == set(y), f"phase 19 {what}: {path} keys")
                for k in y:
                    walk(x[k], y[k], f"{path}.{k}")
            elif isinstance(y, list):
                check(len(x) == len(y), f"phase 19 {what}: {path} length")
                for i, (u, v) in enumerate(zip(x, y)):
                    walk(u, v, f"{path}[{i}]")
            elif isinstance(y, float):
                rel = abs(x - y) / abs(y) if y else abs(x)
                check(rel <= 1e-12, f"phase 19 {what}: {path} {x!r} "
                                    f"against {y!r}")
                worst[0] = max(worst[0], rel)
            else:
                check(x == y, f"phase 19 {what}: {path} {x!r} against {y!r}")
        walk(a, b, "report")
        return worst[0]

    t19 = time.perf_counter()
    users19 = plan19("users", cuda)
    # the same call on the CPU with the host float64 loop driver and
    # numpy scans (the reference's driver, and the port's fastest on
    # the CPU)
    users19c = plan19("users cpu", "cpu", fixpoint="loop",
                      scan_backend="numpy")
    err19 = same_entries19(users19, users19c, "users, cuda against cpu")
    rel19 = same_curves19(users19, users19c, "users, cuda against cpu")
    # the fleet solve's per-op latencies against the greedy oracle
    oracle19, off, t = 0.0, 0, time.perf_counter()
    for e in users19.compiled:
        g = e.graph
        lat = C.op_latencies(g, users19.comp[off:off + g.n])
        off += g.n
        oracle19 = max(oracle19, float(np.max(np.abs(
            lat - C.oracle_op_latencies(g)))))
    oracle19_s = time.perf_counter() - t
    check(oracle19 <= CLUSTER_TOL_US, f"phase 19: per-op latency "
          f"{oracle19:.3e} us from the oracle")
    # the bench's ranking sanity: an erasure config's degraded p99 is no
    # better than 0.95 of its normal row's (degraded PUTs skip a shard)
    ranking19 = []
    for curve in users19.ranking():
        deg = users19.degraded_curve(curve.config)
        check(deg is not None, f"phase 19: no degraded row for "
                               f"{curve.config.name}")
        ranking19.append(f"{curve.config.name} {curve.users_at_slo:.2f} "
                         f"(degraded {deg.users_at_slo:.2f})")
        if curve.config.scheme.kind == "ec":
            for pn, pd in zip(curve.points, deg.points):
                check(pd.lat.p99_us >= 0.95 * pn.lat.p99_us,
                      f"phase 19: {curve.config.name} degraded p99 "
                      f"{pd.lat.p99_us:.1f} us under its normal "
                      f"{pn.lat.p99_us:.1f} us at {pn.users} users")
    print(f"[19] users ladder [4, 8]: cuda against cpu: programs, "
          f"families and pop orders equal, completions max abs err "
          f"{err19:.3e} us, report numbers max rel {rel19:.3e}; per-op "
          f"latency within {oracle19:.3e} us of the oracle "
          f"({oracle19_s:.2f} s); users at the 10 ms SLO, best first: "
          + "; ".join(ranking19))
    rates19 = [4000.0, 16000.0, 64000.0]
    cold19 = plan19("rate", cuda, rate_ladder=rates19)
    warm19 = plan19("rate warm", cuda, rate_ladder=rates19,
                    warm_ladder=True)
    rrel19 = same_curves19(warm19, cold19, "rate ladder, warm against cold")
    bit19 = warm19.to_json()["curves"] == cold19.to_json()["curves"]
    print(f"[19] rate ladder {rates19}: warm curves against cold max rel "
          f"{rrel19:.3e} (bit-equal: {bit19}); warm hits / attempts "
          f"{warm19.warm_hits}/{warm19.warm_attempts}")
    # one config on the loop driver: the batched scan around the host loop
    spec19l = dataclasses.replace(spec19, scheme=configs19[0].scheme,
                                  placement=configs19[0].placement)
    K.reset_launch_counts()
    reset_solves19()
    t = time.perf_counter()
    loop19 = C.Cluster(spec19l, device=cuda).run(wl19, fixpoint="loop")
    loop19_s = time.perf_counter() - t
    read_counts("19 loop", ["zns_event_scan_batched"])
    check(phase_counts["19 loop"]["zns_fixpoint"] == 0,
          "phase 19 loop: the fixpoint kernel launched")
    auto19 = C.Cluster(spec19l, device=cuda).run(wl19)
    check(loop19.converged and loop19.compiled.program.order_stable,
          "phase 19 loop: not converged or not order-stable")
    check(all(len(a) == len(b) and all(np.array_equal(x, y)
                                       for x, y in zip(a, b))
              for a, b in zip(loop19.compiled.fifo_chains,
                              auto19.compiled.fifo_chains)),
          "phase 19 loop: FIFO pop orders differ from the cuda driver's")
    lerr19 = close(loop19.comp, auto19.comp, dict(rtol=1e-12, atol=0.0),
                   "phase 19: loop against cuda")
    print(f"[19] {configs19[0].name} at 8 users on fixpoint=\"loop\": "
          f"{loop19.compiled.graph.n} events, {solves19['n']} solves, "
          f"{phase_counts['19 loop']['zns_event_scan_batched']} batched "
          f"scan launches, {loop19_s:.3f} s; against the cuda driver max "
          f"abs err {lerr19:.3e} us")
    # the device's idle share of one users-ladder call, profiled again
    # (the profiler can miss every device event of a window: 2 tries)
    for _ in range(2):
        reset_solves19()
        prof19 = device_breakdown(lambda: C.plan_capacity(
            configs19, [4, 8], device=cuda, **kw19))
        if prof19 is not None:
            break
    ccomp.solve_program = ccap.solve_program = real_solve
    idle19 = None if prof19 is None else 1.0 - prof19[1] / prof19[0]
    fp19 = None if prof19 is None else dict(prof19[3]).get("zns_fixpoint")
    # the fixpoint kernel's device time per family block a sweep: the
    # persistent kernel crosses a grid barrier after each block
    per_bs19 = None if not fp19 else \
        fp19 * 1e3 / max(solves19["block_sweeps"], 1)
    print("[19] profiled users-ladder call: " + (
        "no device time recorded" if prof19 is None else
        f"{prof19[0]:.1f} ms wall, {prof19[1]:.4f} ms of device kernels "
        f"in {prof19[2]} device events ({prof19[3]}), device idle "
        f"{100 * idle19:.2f}%; the fixpoint kernel "
        + ("not seen" if per_bs19 is None else
           f"{fp19 / max(solves19['n'], 1):.4f} ms a launch, "
           f"{per_bs19:.3f} us a family block a sweep over "
           f"{solves19['block_sweeps']} blocks x sweeps"))
          + f"; phase 19 took {time.perf_counter() - t19:.1f} s")
    report["zns_fixpoint"]["cluster"] = dict(
        programs=users19.n_programs, events=users19.n_events,
        fleet_sweeps=users19.sweeps_used, calls=calls19,
        rate_warm_hits=warm19.warm_hits,
        rate_warm_attempts=warm19.warm_attempts,
        loop_scan_launches=phase_counts["19 loop"]["zns_event_scan_batched"],
        device_kernel_ms=None if prof19 is None else prof19[1],
        fixpoint_us_per_block_sweep=per_bs19,
        profiled_wall_ms=None if prof19 is None else prof19[0],
        idle_share=idle19)

    # -- phase 20: musicgen-large serving at full width and depth ------------
    t20 = time.perf_counter()
    res20 = generation_phase("20", "musicgen-large", 2, 1024, 2048,
                             ["flash_attention", "rmsnorm"], LOGITS_ATOL,
                             F32_LOGITS_ATOL, weight_std=INIT_STD)
    print(f"[20] musicgen-large: prefill {res20['prefill_ms']:.1f} ms, decode "
          f"{res20['decode_ms']:.2f} ms a frame of 4 codebooks (batch 2), "
          f"peak {res20['peak_gb']:.2f} GB; last logits of the 4 codebooks "
          f"kernels vs plain {res20['logits_err']:.3e} (bfloat16, atol "
          f"{LOGITS_ATOL}), {res20['f32_err']:.3e} (float32, atol "
          f"{F32_LOGITS_ATOL}); phase 20 took "
          f"{time.perf_counter() - t20:.1f} s")

    # -- phase 21: internvl2-26b serving at full width and depth -------------
    from repro_torch.serve import make_prefill_step, make_serve_step
    t21 = time.perf_counter()
    # the published config's float32 weights (79.6 GB) fit no 80 GB card:
    # the reference's bfloat16 param_dtype (39.8 GB)
    bf16_params = dict(param_dtype="bfloat16")

    def internvl2_checks(cfg, params, prompt):
        """An image prompt: stub patch embeddings (B, 256, 6,144) from
        default_rng(0), in bfloat16, over the text prompt's first 256
        positions, through make_prefill_step(cfg, 2048) and 8 steps of
        make_serve_step (launches counted, times).  Its last logits with
        the kernels against the plain versions: the float32 model's at
        F32_LOGITS_ATOL, and the bfloat16 model's against the float32
        model's, no farther than the plain versions' plus LOGITS_ATOL.
        Then the bfloat16 model layer by layer from the plain chain's
        input (the image prompt's): each layer's kernels output against
        the same layer in float32 from the same input, no farther than
        the plain versions' output plus BF16_BLOCK_TOL."""
        from repro_torch.models import common as mc
        b, s = prompt.shape
        plain = dataclasses.replace(cfg, kernel_impl="torch")
        f32 = dataclasses.replace(cfg, dtype="float32")
        patches = torch.as_tensor(np.random.default_rng(0).standard_normal(
            (b, cfg.num_patches, cfg.d_model)), dtype=torch.float32).to(
                cuda, torch.bfloat16)
        prefill, step = make_prefill_step(cfg, 2048), make_serve_step(cfg)
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tok, cache = prefill(params, prompt, patches)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t) * 1e3
        toks, step_ms = [tok], []
        for i in range(8):
            t = time.perf_counter()
            tok, cache = step(params, cache, tok, s + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            toks.append(tok)
        read_counts("21 image", ["flash_attention", "rmsnorm"])
        toks = torch.stack(toks, 1)
        check(tuple(toks.shape) == (b, 9) and bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"phase 21 image prompt: tokens {toks.tolist()}")
        del cache
        last = {}
        for name, c in (("bfloat16", cfg), ("float32", f32)):
            for impl in ("cuda", "torch"):
                logits, _ = M.prefill(dataclasses.replace(c, kernel_impl=impl),
                                      params, prompt, 2048, patches)
                last[name, impl] = logits[:, -1].cpu().numpy()
        text, _ = M.prefill(plain, params, prompt, 2048)
        moved = float(np.abs(last["bfloat16", "torch"]
                             - text[:, -1].cpu().numpy()).max())
        check(moved > 0, "phase 21: the image left the last logits as the "
                         "text prompt's")
        f32_err = close(last["float32", "cuda"], last["float32", "torch"],
                        dict(rtol=0.0, atol=F32_LOGITS_ATOL),
                        "phase 21 image prompt float32 last logits, kernels "
                        "vs plain")
        err = float(np.abs(last["bfloat16", "cuda"]
                           - last["bfloat16", "torch"]).max())
        to_f32, plain_f32 = (float(np.abs(last["bfloat16", impl]
                                          - last["float32", "cuda"]).max())
                             for impl in ("cuda", "torch"))
        check(to_f32 <= plain_f32 + LOGITS_ATOL,
              f"phase 21 image prompt: the kernels' bfloat16 last logits are "
              f"{to_f32:.3e} from the float32 model's, the plain versions' "
              f"{plain_f32:.3e} (+ {LOGITS_ATOL} allowed)")
        tol = BF16_BLOCK_TOL
        layers = []
        with torch.inference_mode():
            x = mc.apply_frontend(cfg, params.embed, mc.embed_tokens(
                cfg, params.embed, prompt, torch.bfloat16), patches)
            pos = torch.arange(s, dtype=torch.int32,
                               device=cuda).expand(b, s)
            for i, layer in enumerate(params.layers):
                got, want = (layer(c, x, pos)[0] for c in (cfg, plain))
                exact = layer(dataclasses.replace(f32, kernel_impl="torch"),
                              x.float(), pos)[0]
                e_plain = float((want.float() - exact).abs().max())
                excess = float(((got.float() - exact).abs() - tol["atol"]
                                - tol["rtol"] * exact.abs()).max()) - e_plain
                check(excess <= 0, f"phase 21 layer {i}: the kernels' "
                                   f"bfloat16 output is {excess:.3e} farther "
                                   f"from the float32 layer than the plain "
                                   f"versions' error and {tol} allow")
                layers.append((float((got - want).float().abs().max()),
                               float((got.float() - exact).abs().max()),
                               e_plain))
                x = want
        worst = max(range(len(layers)), key=lambda i: layers[i][0])
        step_ms.sort()
        print(f"[21] image prompt ({b} x {s:,} tokens, patches "
              f"{tuple(patches.shape)} over the first {cfg.num_patches}): "
              f"make_prefill_step {pre_ms:.1f} ms, serve step "
              f"{step_ms[len(step_ms) // 2]:.2f} ms (median of 8, "
              f"{step_ms[0]:.2f}..{step_ms[-1]:.2f}); last logits kernels "
              f"vs plain {f32_err:.3e} (float32 activations over the "
              f"bfloat16 weights, atol {F32_LOGITS_ATOL}), {err:.3e} "
              f"(bfloat16); bfloat16 against the float32 model: kernels "
              f"{to_f32:.3e}, plain {plain_f32:.3e}; the image moved them "
              f"{moved:.3e} from the text prompt's; tokens "
              f"{toks[0].tolist()}")
        print(f"[21] bfloat16 layer by layer from the plain chain's input "
              f"(image prompt), each within the plain versions' error to the "
              f"float32 layer and {tol}: kernels vs plain largest "
              f"{layers[worst][0]:.3e} at layer {worst} (to float32: kernels "
              f"{layers[worst][1]:.3e}, plain {layers[worst][2]:.3e}); "
              f"layers 0-3 kernels vs plain "
              f"{[f'{e[0]:.3e}' for e in layers[:4]]}; max |x| "
              f"{float(x.float().abs().max()):.1f} after layer "
              f"{len(layers) - 1}")
        return dict(prefill_ms=pre_ms, decode_ms=step_ms[len(step_ms) // 2],
                    logits_err=err, f32_err=f32_err, to_f32=to_f32,
                    plain_f32=plain_f32, layers=layers)

    res21 = generation_phase("21", "internvl2-26b", 2, 1024, 2048,
                             ["flash_attention", "rmsnorm"], None,
                             F32_LOGITS_ATOL, extra=internvl2_checks,
                             weight_std=INIT_STD, overrides=bf16_params)
    img21 = res21["block_errs"]
    # The bfloat16 whole-model logits, kernels against plain, are not held
    # at LOGITS_ATOL (None above): each MLP's 16,384 bfloat16 products turn
    # one-step differences of its input into ~0.1 at its output, and over 48
    # layers both bfloat16 models end ~0.8 from the float32 model.  Each is
    # held against the float32 model instead: the kernels' no farther than
    # the plain versions' plus LOGITS_ATOL.
    check(res21["to_f32"] <= res21["plain_f32"] + LOGITS_ATOL,
          f"phase 21 text prompt: the kernels' bfloat16 last logits are "
          f"{res21['to_f32']:.3e} from the float32 model's, the plain "
          f"versions' {res21['plain_f32']:.3e} (+ {LOGITS_ATOL} allowed)")
    print(f"[21] bfloat16 last logits, kernels vs plain "
          f"{res21['logits_err']:.3e} (text), {img21['logits_err']:.3e} "
          f"(image); against the float32 model: kernels "
          f"{res21['to_f32']:.3e} / {img21['to_f32']:.3e}, "
          f"plain {res21['plain_f32']:.3e} / {img21['plain_f32']:.3e} "
          f"(kernels held within plain + {LOGITS_ATOL})")
    # the serving driver takes the published config: give it the bfloat16
    # weights for this call
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    published = lserve.get_config
    lserve.get_config = lambda arch: get_config(arch, **bf16_params)
    try:
        stats = lserve.main(["--arch", "internvl2-26b", "--requests", "16",
                             "--batch", "4", "--max-seq", "128", "--max-new",
                             "32", "--seed", "0"])
    finally:
        lserve.get_config = published
    torch.cuda.synchronize()
    read_counts("21 serve", ["rmsnorm"])
    check(stats["done"] == 16, f"phase 21: {stats['done']}/16 requests")
    print(f"[21] internvl2-26b: text prefill {res21['prefill_ms']:.1f} ms, "
          f"decode {res21['decode_ms']:.2f} ms/token (batch 2), peak "
          f"{res21['peak_gb']:.2f} GB; serve driver (bfloat16 weights): "
          f"{stats['done']} requests, {stats['steps']} decode steps in "
          f"{stats['seconds']:.2f} s, {stats['tok_per_s']:.1f} tok/s (batch "
          f"4), {stats['seconds'] / stats['steps'] * 1e3:.2f} ms/step, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase 21 took "
          f"{time.perf_counter() - t21:.1f} s")
    torch.cuda.empty_cache()

    # -- phase 22: musicgen-large training at full width and depth -----------
    t22 = time.perf_counter()
    cfg22 = get_config("musicgen-large")
    L22 = cfg22.num_layers
    runs22 = mc.layer_forward_runs(cfg22, L22)
    per_step22 = {"rmsnorm": 2 * runs22 + 1, "rmsnorm_bwd": 2 * L22 + 1,
                  "flash_attention": runs22, "flash_attention_bwd": L22}
    data22 = DataConfig(cfg22.vocab_size, 2048, 4,
                        num_codebooks=cfg22.num_codebooks)
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    res22 = ltrain.main(["--arch", "musicgen-large", "--batch", "4",
                         "--seq-len", "2048", "--lr", "3e-3", "--warmup", "2",
                         "--log-every", "1", "--init-std", str(INIT_STD),
                         "--steps", "4", "--seed", "0"])
    torch.cuda.synchronize()
    wall22 = time.perf_counter() - t
    peak22 = torch.cuda.max_memory_allocated() / 1e9
    read_counts("22", list(per_step22))
    for k, v in phase_counts["22"].items():
        want = 4 * per_step22.get(k, 0)
        check(v == want, f"phase 22: {k} launched {v} times in 4 steps, "
                         f"want {want} ({per_step22} a step)")
    losses22 = res22["losses"]
    check(len(losses22) == 4 and bool(np.isfinite(losses22).all()),
          f"phase 22: losses {losses22}")
    state22 = res22["state"]
    step22 = make_train_step(cfg22, AdamWConfig(lr=3e-3, warmup_steps=2,
                                                total_steps=4))
    batch22 = TokenPipeline(data22).batch_at(4)
    step_ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state22, _ = step22(state22, batch22)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    # the profiler can miss every device event of a window: up to 3 tries
    for _ in range(3):
        brk = device_breakdown(lambda: step22(state22, batch22))
        if brk is not None:
            break
    check(brk is not None, "phase 22: torch.profiler recorded no device time")
    wall_p, busy, nev, groups, _ = brk
    for g in ("flash_attention", "flash_attention_bwd", "rmsnorm",
              "rmsnorm_bwd"):
        check(dict(groups).get(g, 0.0) > 0, f"phase 22: the profiler saw no "
                                            f"{g} kernel in a step")
    frames_s = 4 * 2048 / (min(step_ms) / 1e3)
    print(f"[22] musicgen-large at full size "
          f"({M.count_params(cfg22) / 1e9:.3f}e9 float32 parameters from seed 0, weights N(0, {INIT_STD}), "
          f"bfloat16 activations, remat full, 4 x 2,048 frames x 4 "
          f"codebooks): 4 steps through launch.train in {wall22:.2f} s, "
          f"losses {[round(x, 4) for x in losses22]}; step "
          f"{min(step_ms):.1f} ms ({step_ms}), {frames_s:.0f} frames/s, peak "
          f"memory {peak22:.2f} GB; launches a step {per_step22} ({runs22} "
          f"layer forwards a step)")
    print(f"[22] one step under torch.profiler: wall {wall_p:.1f} ms, {nev} "
          f"device events, kernels {busy:.1f} ms, device idle "
          f"{max(0.0, 1 - busy / wall_p):.1%}; " + ", ".join(
              f"{g} {ms:.2f} ms" for g, ms in groups))
    report22 = dict(step_ms=min(step_ms), frames_per_s=frames_s,
                    peak_gb=peak22, losses=losses22,
                    idle=max(0.0, 1 - busy / wall_p), groups=groups)
    del res22, state22, step22
    torch.cuda.empty_cache()

    # the first step's bfloat16 gradients at full width and 2 layers,
    # kernels against plain versions, the codebook leaves among them
    two22 = dataclasses.replace(cfg22, num_layers=2)
    tree22 = M.init_params(two22, torch.Generator(cuda).manual_seed(0),
                           device=cuda, weight_std=INIT_STD).param_tree()
    first22 = {"tokens": torch.as_tensor(
        TokenPipeline(data22).batch_at(0)["tokens"], device=cuda)}
    K.reset_launch_counts()
    l_k, g_k = first_step_grads(two22, tree22, first22)
    check(kfa.flash_attention_bwd.launches == 2
          and krms.rmsnorm_bwd.launches == 5,
          f"phase 22: the 2-layer kernel step launched the attention "
          f"backward {kfa.flash_attention_bwd.launches} and the RMSNorm "
          f"backward {krms.rmsnorm_bwd.launches} times (want 2 and 5)")
    l_p, g_p = first_step_grads(
        dataclasses.replace(two22, kernel_impl="torch"), tree22, first22)
    paths22 = ["/".join(p) for p, _ in mc.spec_leaves(M.model_spec(two22))]
    check(any("codebook_embed" in p for p in paths22)
          and any("codebook_head" in p for p in paths22),
          f"phase 22: no codebook leaves in {paths22}")
    gaps = sorted(((float((a - b).float().norm()
                          / b.float().norm().clamp_min(1e-30)), p)
                   for p, a, b in zip(paths22, tree_leaves(g_k),
                                      tree_leaves(g_p))), reverse=True)
    print(f"[22] bfloat16 first-step gradients at full width, 2 layers: loss "
          f"kernels {l_k!r}, plain {l_p!r}; every leaf's relative gap within "
          f"{BF16_GRAD_REL}; largest " + "; ".join(
              f"{p} {g:.2e}" for g, p in gaps[:4]) + "; " + "; ".join(
              f"{p} {g:.2e}" for g, p in gaps if "codebook" in p)
          + f"; phase 22 took {time.perf_counter() - t22:.1f} s")
    for g, p in gaps:
        check(np.isfinite(g) and g <= BF16_GRAD_REL,
              f"phase 22: bfloat16 gradient {p}: relative gap {g:.3e} "
              f"between kernels and plain versions exceeds {BF16_GRAD_REL}")
    report22["bf16_grad_gap"] = gaps[0][0]
    report["flash_attention_bwd"]["training_musicgen"] = report22
    del g_k, g_p, tree22
    torch.cuda.empty_cache()

    # -- phases 23-24: the recurrent families train on the kernels ------------
    def train_phase(phase, arch, argv, cfg, per_step, batch, seq, groups,
                    need):
        """Four steps through launch.train at RECURRENT_LR (launches
        exactly per_step a step, losses finite and falling), two timed
        steps and a profiled one; returns the report row."""
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        res = ltrain.main(recurrent_argv(phase, arch, batch, seq) + argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() / 1e9
        read_counts(phase, need)
        for k, v in phase_counts[phase].items():
            want = 4 * per_step.get(k, 0)
            check(v == want, f"phase {phase}: {k} launched {v} times in 4 "
                             f"steps, want {want} ({per_step} a step)")
        losses = res["losses"]
        check(len(losses) == 4 and bool(np.isfinite(losses).all()),
              f"phase {phase}: losses {losses}")
        check(losses[-1] < losses[0], f"phase {phase}: the loss did not "
                                      f"fall: {losses}")
        state = res["state"]
        step = make_train_step(cfg, AdamWConfig(lr=RECURRENT_LR[phase],
                                                warmup_steps=2,
                                                total_steps=4))
        data = TokenPipeline(DataConfig(cfg.vocab_size, seq, batch))
        bt = data.batch_at(4)
        step_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, _ = step(state, bt)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
        for _ in range(3):   # the profiler can miss a window's device events
            brk = device_breakdown(lambda: step(state, bt))
            if brk is not None:
                break
        check(brk is not None, f"phase {phase}: torch.profiler recorded no "
                               f"device time")
        wall_p, busy, nev, grp, _ = brk
        for g in groups:
            check(dict(grp).get(g, 0.0) > 0, f"phase {phase}: the profiler "
                                             f"saw no {g} kernel in a step")
        tok_s = batch * seq / (min(step_ms) / 1e3)
        print(f"[{phase}] {arch} ({M.count_params(cfg) / 1e9:.3f}e9 float32 "
              f"parameters from seed 0, {cfg.num_layers} layers, weights "
              f"N(0, {INIT_STD}), bfloat16 activations, remat full, {batch} "
              f"x {seq:,} tokens): 4 steps through launch.train in "
              f"{wall:.2f} s, losses {[round(x, 4) for x in losses]}; step "
              f"{min(step_ms):.1f} ms ({step_ms}), {tok_s:.0f} tokens/s, "
              f"peak memory {peak:.2f} GB; launches a step {per_step}")
        print(f"[{phase}] one step under torch.profiler: wall {wall_p:.1f} "
              f"ms, {nev} device events, kernels {busy:.1f} ms, device idle "
              f"{max(0.0, 1 - busy / wall_p):.1%}; " + ", ".join(
                  f"{g} {ms:.2f} ms" for g, ms in grp))
        row = dict(step_ms=min(step_ms), tokens_per_s=tok_s, peak_gb=peak,
                   losses=losses, grad_norms=res["grad_norms"],
                   idle=max(0.0, 1 - busy / wall_p),
                   groups=grp, layers=cfg.num_layers)
        del res, state, step
        torch.cuda.empty_cache()
        return row

    def tree_to(tree, device):
        return {k: tree_to(v, device) if isinstance(v, dict)
                else v.to(device) for k, v in tree.items()}

    def hold_first_grads(phase, cfg, batch, need, offload=False,
                         hold_bf16=True):
        """The first step's gradients at cfg's (cut) depth: float32 kernels
        within the plain float32 step's error to a float64 plain step plus
        GRAD_F64_FRAC of each leaf's scale, as phase 18; bfloat16 kernels
        against plain within BF16_GRAD_REL (``hold_bf16`` False: the gap
        is printed, not held).  ``need``: {counter: launches} of the
        float32 kernel step.  ``offload`` keeps the float32 parameters and
        gradients in host memory during the float64 step."""
        tree = M.init_params(cfg, torch.Generator(cuda).manual_seed(0),
                             device=cuda, weight_std=INIT_STD).param_tree()
        f32 = dataclasses.replace(cfg, dtype="float32")
        K.reset_launch_counts()
        l_k, g_k = first_step_grads(f32, tree, batch)
        got = {k: K.launch_counts()[k] for k in need}
        check(got == need, f"phase {phase}: the float32 kernel step "
                           f"launched {got}, want {need}")
        l_p, g_p = first_step_grads(dataclasses.replace(
            f32, kernel_impl="torch"), tree, batch)
        check(all(K.launch_counts()[k] == need[k] for k in need),
              f"phase {phase}: the plain step launched a kernel")
        leaves_k, leaves_p = tree_leaves(g_k), tree_leaves(g_p)
        tree64 = tree_as(tree, torch.float64)
        if offload:
            leaves_k = [u.cpu() for u in leaves_k]
            leaves_p = [u.cpu() for u in leaves_p]
            tree = tree_to(tree, "cpu")
        del g_k, g_p
        torch.cuda.empty_cache()
        f64 = dataclasses.replace(cfg, dtype="float64",
                                  param_dtype="float64", kernel_impl="torch")
        torch.cuda.reset_peak_memory_stats()
        l_64, g_64 = first_step_grads(f64, tree64, batch)
        del tree64
        peak64 = torch.cuda.max_memory_allocated() / 1e9
        paths = ["/".join(p) for p, _ in mc.spec_leaves(M.model_spec(cfg))]
        worst, excess_max = [], -1.0
        for path, gk, gp, g64 in zip(paths, leaves_k, leaves_p,
                                     tree_leaves(g_64)):
            gk, gp = gk.to(cuda), gp.to(cuda)
            scale = float(g64.abs().max())
            e_k = float((gk.double() - g64).abs().max())
            e_p = float((gp.double() - g64).abs().max())
            excess = e_k - e_p - GRAD_F64_FRAC * scale
            excess_max = max(excess_max, excess / max(scale, 1e-30))
            worst.append((e_k / max(scale, 1e-30), e_p / max(scale, 1e-30),
                          path))
            check(excess <= 0, f"phase {phase}: gradient {path}: the "
                               f"kernels' float32 error to float64 "
                               f"{e_k:.3e} exceeds the plain float32 error "
                               f"{e_p:.3e} plus {GRAD_F64_FRAC} of its "
                               f"scale {scale:.3e}")
        worst.sort(reverse=True)
        print(f"[{phase}] first-step gradients at full width, "
              f"{cfg.num_layers} layers: loss kernels {l_k!r}, plain "
              f"{l_p!r}, float64 {l_64!r}; every leaf's float32 error to the "
              f"float64 step within the plain float32 step's plus "
              f"{GRAD_F64_FRAC}; largest kernels / plain: " + "; ".join(
                  f"{p} {a:.2e} / {b:.2e}" for a, b, p in worst[:4])
              + f"; peak of the float64 step {peak64:.2f} GB")
        del leaves_k, leaves_p, g_64
        torch.cuda.empty_cache()
        tree = tree_to(tree, cuda)
        l_kb, g_kb = first_step_grads(cfg, tree, batch)
        l_pb, g_pb = first_step_grads(dataclasses.replace(
            cfg, kernel_impl="torch"), tree, batch)
        gaps = sorted(((float((a - b).float().norm()
                              / b.float().norm().clamp_min(1e-30)), p)
                       for p, a, b in zip(paths, tree_leaves(g_kb),
                                          tree_leaves(g_pb))), reverse=True)
        held = (f"every leaf's relative gap within {BF16_GRAD_REL}"
                if hold_bf16 else "not held")
        print(f"[{phase}] bfloat16 first-step gradients at {cfg.num_layers} "
              f"layers, kernels vs plain: loss {l_kb!r} vs {l_pb!r}; {held}; "
              f"largest relative gaps " + "; ".join(
                  f"{p} {g:.2e}" for g, p in gaps[:4]))
        for g, p in gaps:
            check(np.isfinite(g) and (g <= BF16_GRAD_REL or not hold_bf16),
                  f"phase {phase}: bfloat16 gradient {p}: relative gap "
                  f"{g:.3e} between kernels and plain versions exceeds "
                  f"{BF16_GRAD_REL}")
        del g_kb, g_pb, tree
        gc.collect()   # the steps' graphs hold reference cycles
        torch.cuda.empty_cache()
        return dict(grad_excess=excess_max, bf16_grad_gap=gaps[0][0],
                    f64_peak_gb=peak64)

    # -- phase 23: mamba2-370m training at full width and depth ---------------
    t23 = time.perf_counter()
    cfg23 = get_config("mamba2-370m")
    L23 = cfg23.num_layers
    runs23 = mc.layer_forward_runs(cfg23, L23)
    per_step23 = {"rmsnorm": 2 * runs23 + 1, "rmsnorm_bwd": 2 * L23 + 1,
                  "ssd_chunk_scan": runs23, "ssd_chunk_scan_bwd": L23,
                  "ssd_chunk_scan_mma": runs23,
                  "ssd_chunk_scan_bwd_mma": L23}
    report23 = train_phase("23", "mamba2-370m", [], cfg23, per_step23, 4,
                           2048, ("ssd_chunk_scan", "ssd_chunk_scan_bwd",
                                  "rmsnorm", "rmsnorm_bwd"),
                           ["ssd_chunk_scan", "ssd_chunk_scan_bwd"])
    batch23 = {"tokens": torch.as_tensor(TokenPipeline(DataConfig(
        cfg23.vocab_size, 2048, 4)).batch_at(0)["tokens"], device=cuda)}
    report23.update(hold_first_grads(
        "23", dataclasses.replace(cfg23, num_layers=2), batch23,
        {"ssd_chunk_scan_bwd": 2, "rmsnorm_bwd": 5}))
    # and at all 48 layers, the 48 chained SSD backwards together: float32
    # held against float64 as above; the bfloat16 gap printed
    t = time.perf_counter()
    report23["full_depth"] = hold_first_grads(
        "23", cfg23, batch23, {"ssd_chunk_scan_bwd": L23,
                               "rmsnorm_bwd": 2 * L23 + 1}, hold_bf16=False)
    print(f"[23] the {L23}-layer gradient holds took "
          f"{time.perf_counter() - t:.1f} s")
    print(f"[23] phase 23 took {time.perf_counter() - t23:.1f} s")
    report["ssd_chunk_scan_bwd"]["training"] = report23

    # -- phase 24: recurrentgemma-9b training at full width, 6 layers -------
    # Two (rec, rec, attn) groups: 3.28e9 parameters (the embedding and
    # the head, untied, are 2.1e9), 52.5 GB of float32 state with AdamW
    # (the 38 blocks' 154 GB fit no card); 4,096 tokens, so that the
    # window of 2,048 masks.
    t24 = time.perf_counter()
    print(f"[24] device memory held entering the phase: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    argv24 = ["--d-model", "4096", "--d-ff", "12288", "--layers", "6"]
    cfg24 = dataclasses.replace(get_config("recurrentgemma-9b"),
                                num_layers=6)
    G24 = cfg24.num_layers // len(cfg24.block_pattern)
    runs24 = mc.layer_forward_runs(cfg24, G24)
    per_step24 = {"rmsnorm": 6 * runs24 + 1, "rmsnorm_bwd": 6 * G24 + 1,
                  "linear_recurrence": 2 * runs24,
                  "linear_recurrence_bwd": 2 * G24,
                  "flash_attention": runs24, "flash_attention_bwd": G24,
                  "flash_attention_bwd_d256": G24}
    report24 = train_phase("24", "recurrentgemma-9b", argv24, cfg24,
                           per_step24, 1, 4096,
                           ("linear_recurrence", "linear_recurrence_bwd",
                            "flash_attention", "flash_attention_bwd",
                            "rmsnorm", "rmsnorm_bwd"),
                           ["linear_recurrence_bwd", "flash_attention_bwd"])
    # the gradient check at one group (rec, rec, attn) on 2,304 tokens
    # (more than the window): the float64 step holds 21.5 GB of
    # parameters, as much gradient, and logits of 4.7 GB a copy
    batch24 = {"tokens": torch.as_tensor(TokenPipeline(DataConfig(
        cfg24.vocab_size, 2304, 1)).batch_at(0)["tokens"], device=cuda)}
    report24.update(hold_first_grads(
        "24", dataclasses.replace(cfg24, num_layers=3), batch24,
        {"linear_recurrence_bwd": 2, "flash_attention_bwd": 1,
         "rmsnorm_bwd": 7}, offload=True))
    print(f"[24] phase 24 took {time.perf_counter() - t24:.1f} s")
    report["linear_recurrence_bwd"]["training"] = report24

    # -- phase 25: distributed/ on four ranks that share the card ------------
    start_early_dryruns()      # phase 26's long traces, on the host's cores
    gc.collect()
    torch.cuda.empty_cache()
    p23 = dict(losses=report23["losses"], grad_norms=report23["grad_norms"])
    got25 = phase25(dict(losses=losses18[:RL_STEPS],
                         grad_norms=grad_norms18[:RL_STEPS], peak_gb=peak18,
                         mb2=rl_reference(train_args)), p23)
    for k, v in got25.items():
        launches[k] += v
    phase_counts["25"] = got25

    # -- phase 26: the dry run and its roofline -------------------------------
    phase26(card, p18)

    # -- phase 27: the examples and scripts, run as users run them ----------
    got27 = phase27(card)
    for k, v in got27["launches"].items():
        launches[k] += v
    phase_counts["27"] = got27["launches"]

    # -- report -----------------------------------------------------------------
    sources = {
        "zns_event_scan": ("src/repro_torch/csrc/zns_event_scan.cu",
                           "src/repro/kernels/zns_event_scan.py:118"),
        "zns_event_scan_batched": ("src/repro_torch/csrc/zns_event_scan.cu",
                                   "src/repro/kernels/zns_event_scan.py:86"),
        "zns_fixpoint": ("src/repro_torch/csrc/zns_fixpoint.cu",
                         "src/repro/kernels/zns_fixpoint.py:225"),
        "zns_fixpoint_sharded": ("src/repro_torch/csrc/zns_fixpoint.cu",
                                 "src/repro/kernels/zns_fixpoint.py:301"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:77"),
        "flash_attention_bwd": ("src/repro_torch/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:77"),
        "rmsnorm": ("src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:28"),
        "rmsnorm_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:28"),
        "rmsnorm_cut": ("src/repro_torch/csrc/rmsnorm.cu",
                        "src/repro/kernels/rmsnorm.py:28"),
        "rmsnorm_cut_bwd": ("src/repro_torch/csrc/rmsnorm.cu",
                            "src/repro/kernels/rmsnorm.py:28"),
        "ssd_chunk_scan": ("src/repro_torch/csrc/ssd_chunk_scan.cu",
                           "src/repro/kernels/ssd_chunk_scan.py:76"),
        "linear_recurrence": ("src/repro_torch/csrc/linear_recurrence.cu",
                              "src/repro/kernels/linear_recurrence.py:45"),
        "linear_recurrence_bwd": (
            "src/repro_torch/csrc/linear_recurrence.cu",
            "src/repro/kernels/linear_recurrence.py:45"),
        "ssd_chunk_scan_bwd": ("src/repro_torch/csrc/ssd_chunk_scan.cu",
                               "src/repro/kernels/ssd_chunk_scan.py:76"),
        "flash_attention_bwd_d256": (
            "src/repro_torch/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:77"),
    }
    kernels = []
    for name, (source, replaces) in sources.items():
        r = report[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            **{k: v for k, v in r.items() if k not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}))
    check(all(k["launches"] > 0 for k in kernels),
          f"a kernel was never launched on the main path: {launches}")
    print(f"[total] {time.perf_counter() - t0:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
