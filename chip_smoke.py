#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases (any failure raises and the script exits non-zero):

  1. device: the card's name, count and ``nvidia-smi`` name/power limit.
  2. build: compile the five CUDA sources into six libraries (the comm
     plane's, rmsnorm's, flash attention's float32 kernels, its bfloat16
     kernels and, from the same source with -DLAG_FLASH_F16, its float16
     kernels, and the legacy per-leaf kernels) with nvcc (sm_90a), one
     process each, all at once; ptxas's registers and spills of every
     kernel, the flash kernels' shared memory per head_dim, a check that
     none of the float32 flash library's six instantiations (head_dim 64,
     80, 128, 256; wide 384, 512) spills, the count of ``HGMMA``
     instructions (wgmma) in the bfloat16 and float16 flash libraries' SASS
     (``cuobjdump -sass``), which must not be 0, each wide
     instantiation's own tensor-core instructions (HMMA in float32, HGMMA
     in 2-byte), none of which may be 0, and in each float16
     ``flash_f16_kernel`` instantiation at most one wgmma wait
     (WARPGROUP.DEPBAR) for every four HGMMA: ptxas did not serialize
     its products.
  3. the comm plane's kernels vs plain versions on ragged synthetic
     layouts (leaf sizes {1, 127, 129, 32768, 0}, W ∈ {1, 3}, the
     unstacked operand, LAQ bits {2, 4, 8}, all three masked modes):
     bitwise for masked_combine, absmax and the LAQ payload/residual, rtol
     1e-5 for the sum partials (delta_sqnorm_blocks, sqnorm_blocks).
  4. the same five kernels at the main path's shapes (llama3.2-1b's flat
     layout, W = 2: 2.47e9 elements per operand, above 2^31), against the
     plain versions applied in row chunks, with their times.
  5. the main path: ``repro_torch.launch.train`` on llama3.2-1b at full
     width and depth, W = 2, batch 4, seq 256, 4 rounds of lag-wk, then of
     laq@4, with random weights from a seed; launch counters reset just
     before each run and read just after.
  6. agreement on a small input: the reduced model, 3 rounds per policy,
     on the GPU (kernels) and on the CPU (plain versions) from the same
     weights — equal upload masks, losses within rtol 1e-4: lag-wk and
     laq@4 on the batched plane and on the legacy per-leaf route
     (``use_pallas_comm``), lasg-wk on both, cyc-laq@4 on the plane,
     lag-adam (lr 1e-3) on the plane.  On the plane, the LAQ quantizer steps
     on the card equal bit for bit the IEEE division of the same scales on
     the CPU.
  7. the model kernels (rmsnorm, flash attention) vs their plain versions
     at ragged shapes (rows {1, 7, 129, 1000} x d {2048, 256, 132}; S {1,
     7, 63, 64, 65, 127, 128, 129, 1000, 2047} on and around the flash
     kernel's 64-row and 64-key tile edges, causal / windows 16, 64, 100
     that straddle tiles / non-causal, GQA 32/8, Sq != Skv both ways) and
     at the serving path's shapes (rmsnorm (8192, 2048); attention (4,
     2048, 32/8, 64) causal), within rtol = atol = 1e-5, with their times
     against their bounds, the plain versions and one PyTorch call each.
     RMSNorm's times are its three readings (``rms_readings``), the
     kernel's and ``F.rms_norm``'s alike: back to back on a rotation of
     inputs larger than the L2 (cold), device-only (the same launches
     queued behind ``torch.cuda._sleep``, ``Event.query()`` confirming the
     host had enqueued them all first), and the host's µs a call; the
     kernels line takes the device-only times.
     The flash kernel's bound is its split-TF32 work on the tensor cores;
     the float32 FMA units' bound and the kernel-to-library ratio are
     printed beside it.
  8. the serving path: ``repro_torch.launch.serve`` on llama3.2-1b at full
     width and depth, batch 4, prompt 2048, 32 generated tokens, 2 rounds
     (round 0 is warm-up), random weights from seed 0; launch counters
     reset just before and read just after: rmsnorm 33 and flash attention
     16 launches per prefill, none per decode step.  Then the prefill
     through the kernels (``use_pallas=True``) against the plain route on
     the card (``use_pallas=False``) on one prompt batch: last-position
     logits and every layer's KV cache within 2e-3, the reference's own
     tolerance for its Pallas route against XLA (tests/test_kernels.py).
  9. the five legacy per-leaf kernels (``kernels/lag_trigger``) vs their
     plain versions at ragged sizes ({1, 3, 127, 129, 1000, 257·33, 32768,
     32769}, aligned and one element off, float32 and bfloat16 where the
     kernel takes it, bits {2, 4, 8}, m ∈ {0, 1}) and at every one of
     llama3.2-1b's 11 full-width leaves: bitwise for the masked update,
     absmax, LAQ payload/residual and steps, rtol 1e-5 for the sums; one
     round's launches (11 leaves × W = 2) timed against the bound, the
     plain versions and one PyTorch call where one exists.
 10. the legacy per-leaf route: ``repro_torch.launch.train`` with
     ``use_pallas_comm=True`` for lag-wk, lag-ps and laq@4 in phase 5's
     configuration; launches per round (sqnorm_2d 22 for lag-wk and
     lag-ps; innovation_absmax_2d and laq_encode_2d 22 for laq@4; none of
     the batched plane's), peak memory under 80 GB, and for lag-wk and
     laq@4 phase 5's masks and losses within rtol 1e-4.
 11. LASG-WK, the schedules and the server steps through
     ``repro_torch.launch.train`` in phase 5's configuration: lasg-wk on
     the plane (its second backward pass at θ̂_m; delta_sqnorm_blocks and
     masked_combine's add and select every round) and on the legacy route
     (sqnorm_2d 22 a round, none of the plane's), cyc-iag and num-iag (the
     GD payload: no plane kernel, as in the reference), cyc-laq@4 on the
     plane (absmax, encode, masked_combine), lag-adam at lr 1e-3, lag-wk
     with ``--server momentum@0.9`` and with ``--server prox-l1@1e-6``.
     Each run's losses, masks, ms a round, device fwd/bwd and comm ms, peak
     memory (under 80 GB) and launches; a schedule uploads from exactly its
     scheduled worker every round.
 12. the paper's convex parameter-server simulation
     (``repro_torch.core.simulate.run`` → ``Experiment(problem=)`` →
     ``SimWorkers``), each run's ms per round on the card and on the CPU:
     a. Fig. 3 (``synthetic("linreg")``, 9 workers, d 50) in float64 on
        the card, K = 600, every ``ALGOS`` entry on the plain route (no
        plane kernel): iterations, uploads and bytes to ε = 1e-8 equal to
        the reference's (gd, lag-wk, lag-ps, lasg-wk, cyc-iag) and to the
        port's CPU run (all seven; laq's IEEE quantizer and num-iag's own
        draw), masks equal to the CPU run's through its iters_to(1e-6)
        (all K where it is never reached), losses within rtol 1e-12 there
        and at the last round;
     b. the same problem in float32 on the batched plane (``fastpath``
        "auto" on the card) for lag-wk, lag-ps, lasg-wk, laq@4 and
        cyc-laq@4 (at IAG's α = 1/(M·L)), K = 300: the plane's kernels vs
        their plain versions at this path's shapes (9 workers × 256 rows),
        the kernels each round launches, masks and losses against the CPU
        run with ``fastpath="on"`` (the kernels' plain versions) through
        the ε the float32 runs reach;
     c. Gisette at the paper's own shape (``gisette_standin(n=2000,
        d=4837)``, float64, its data made in a CPU-only process of its own,
        ``cpu_child``, beside phases 3-12): ``optimum()`` timed, gd and
        lag-wk at K = 3000 with iterations and uploads to 1e-8, the first
        20 rounds' masks and losses against a CPU run;
     d. ``Experiment(problem=hetero_problem("linreg", h=0.8, float64),
        algo="lag-wk", steps=600, cluster="hetero:9@10ms/1Gbps")``:
        ``seconds_to(1e-8)``, and every round's masks and seconds through
        iters_to(1e-6), equal to the CPU run's; ``wall_seconds`` within
        rtol 1e-3 of the CPU run's (past the optimum the triggers compare
        round-off, and the two devices' float64 products differ in it).
 13. the deep topologies, the fleet and the deep front door, llama3.2-1b at
     full width through ``repro_torch.launch.train`` in phase 5's
     configuration, each run's exact launches a round, ms, device fwd/bwd
     and comm ms and peak memory (under 80 GB):
     a. ``--topology async:2@1`` for lag-wk and lag-ps (the 2-slot θ ring is
        the stacked view: gradients and triggers at θ^{k−s_m});
        ``delta_sqnorm_blocks`` and ``masked_combine`` every round; on the
        reduced model on the card, ``async:2@0`` equal to ``shards`` bit
        for bit (losses, masks, θ);
     b. ``--topology pods:2`` lag-wk: masks and losses bitwise phase 5's
        shards, rounds_skipped; on the reduced model (lr 0.01, one fixed
        batch) a quiet round takes the zero branch on the card, masks
        equal to the CPU's;
     c. ``--topology fleet:4@2`` lag-wk (uniform selection), then with
        ``--fleet-selection innovation --fleet-churn 0.25``, then laq@4 on
        ``fleet:2@1``: cohorts, uploads, the cohort's gather and scatter
        ms; kernel 1 twice a round (the innovation and the trigger);
     d. the convex fleet at ``BENCH_fleet.json``'s scale row
        (``fleet_problem('linreg', n_per=2, d=4)`` float32, N 10,000, k
        625, K 300, lag-wk) priced on ``fleet:10000@50ms/20Mbps``: the
        kernels at the cohort's (625, 256, 128) shape vs their plain
        versions; the card's plane against the CPU's plain kernel versions
        on the port's own draws (the CPU run in a CPU-only process of its
        own, ``cpu_child``, beside phases 3-13): equal cohorts, masks equal
        through iters_to(1e-2) (1e-4 is not reached in 300 rounds), losses
        within rtol 1e-5, ms a round on each;
     e. ``Experiment(model="llama3.2-1b", reduced=False, hetero=0.8,
        cluster="hetero:2@10ms/1Gbps")`` against ``launch.train --hetero
        0.8 --cluster …`` on the same rounds: equal masks, losses and
        priced seconds.
 14. the serverless gossip graph (``repro_torch.graph``) and the
     launcher's checkpoints:
     a. ``launch.train --topology graph:2@ring`` on llama3.2-1b at full
        width and depth, batch 4, seq 256, 4 rounds of lag-wk and of laq@4
        on the plane: (4, E = 2) masks, round 0 on every edge, comm_total
        = Σ masks, finite losses and θ, the plane's exact launches a round,
        ms a round with fwd/bwd, comm (adapt + edge round) and mix ms, and
        the peak;
     b. ``Experiment(model=<llama3.2-1b cut to 2 layers, full width>,
        topology="graph:4@ring")`` lag-wk: E = 8, launches, peak; the same
        through the launcher (``--layers 2``) for the round's phases; then
        the reduced model on the card against the same weights on the CPU
        (phase 6's pattern; lag-wk and laq@4 at ξ = 10, where edges go
        quiet): masks equal, losses within rtol 1e-4;
     c. the convex graph of ``benchmarks/graph_sweep.py`` (linreg, W 9,
        n_per 20, d 10) on ring and torus:3x3, gd / lag-wk / laq@4, K 400:
        float64 on the card against the CPU (iterations and uploads to the
        family's matched ε equal, masks equal through it, losses within
        rtol 1e-12); float32 on the plane against the CPU's plain kernel
        versions (masks equal through iters_to(1e-2), the exact launches);
        the priced seconds on ``hetero:<E>@10ms/1Gbps`` equal to the
        launcher's pricing (``price_edge_mask``) of the same rounds;
     d. resume on the card: ``shards`` and ``graph:2@ring`` lag-wk at full
        width, depth cut to 2 (``--layers 2``), 4 rounds, saved at round 2
        into a temporary directory the phase deletes: the resumed rounds 3
        and 4 equal the uninterrupted ones bit for bit (masks, losses, θ).
  15. every architecture of the dense block kind:
     a. flash attention at head_dim 80 (H 16/16) and 128 (H 24/8) on phase
        7's ragged set, RMSNorm at d 3072, 3584, 4096, 8192 (rows 1, 7,
        129, 1000), each within rtol = atol = 1e-5 of its plain version;
        then the new archs' prefill shapes timed against their bounds, the
        plain versions and one PyTorch call each: flash (4, 2048, 24/8,
        128) and (4, 2048, 28/4, 128) causal, (4, 2048, 16/16, 80)
        non-causal, against their split-TF32 bounds and
        ``F.scaled_dot_product_attention``; RMSNorm (8192, d) against
        ``F.rms_norm`` by its three readings (phase 7).
     b. ``launch.serve`` as phase 8 (launches exactly 2L + 1 RMSNorm and L
        flash per prefill, none per decode step; the prefill's kernel
        route against the plain route within 2e-3; peak under 80 GB) for
        llama3.2-3b, granite-8b, qwen2-vl-7b and command-r-35b (its depth
        cut to 12 of 40 layers: 129.5 GB in float32 at 40), batch 4,
        prompt 2048, 32 tokens, 2 rounds, and llama3.2-1b-sw, batch 2,
        prompt 6144 (past its 4096 window: the rolling cache wraps).
     c. hubert-xlarge's forward at full width and depth (4 x 2048 frames):
        48 flash launches and no RMSNorm (LayerNorm has no kernel), the
        kernel route against the plain route within 2e-3; ``launch.serve``
        refuses it with the reference's reason.
     d. ``launch.train`` in phase 5's configuration on hubert-xlarge (full
        width and depth) with lag-wk and laq@4, and qwen2-vl-7b (full
        width, ``--layers 2``) with lag-wk: losses, masks, times, peak
        under 80 GB, the plane's launches.
     e. the six reduced archs, 3 rounds of lag-wk on the card and on the
        CPU from the same weights: equal masks, losses within rtol 1e-4.
  16. the recurrent and state-space layer kinds (``rec``, ``lattn``,
     ``ssd``):
     a. flash attention at head_dim 256 (H 16/1 and 8/2) on phase 7's
        ragged set within rtol = atol = 1e-5 of its plain version, then at
        recurrentgemma's prefill shape (2, 4096, 16/1, 256) causal with
        window 2048 (its error also against a float64 evaluation of the
        plain version) timed against its split-TF32 bound over the
        (query, key) pairs the masks leave, the plain version and
        ``F.scaled_dot_product_attention`` with the window as a boolean
        mask;
     b. ``launch.serve`` as phase 8 on recurrentgemma-9b at full width and
        depth, batch 2, prompt 4096 (past its 2048 window: the rolling
        cache wraps), and mamba2-370m, batch 4, prompt 2048 (8 SSD
        chunks): launches exactly 77 RMSNorm and 12 flash, and 49 RMSNorm
        and no flash, per prefill, none per decode step; the prefill's
        kernel route against the plain route within 2e-3 (logits and every
        cache leaf: K/V, h, conv windows, SSM state);
     c. ``launch.train`` in phase 5's configuration: mamba2-370m at full
        width and depth, lag-wk and laq@4 at W = 2; recurrentgemma-9b at
        full width, its depth and W the first cut whose peak the dry-run
        (``repro_torch.launch.dryrun``) reckons under 75 GB, of
        ``--layers 5`` at W = 2,
        ``--layers 5`` at W = 1, ``--layers 3`` at W = 1;
     d. recurrentgemma-9b at ``reduced(num_layers=8)`` (two superblocks
        and the tail) and mamba2-370m reduced, 3 rounds of lag-wk on the
        card and on the CPU: equal masks, losses within rtol 1e-4.
  17. the ``moe`` layer kind (qwen3-moe-30b-a3b, qwen3-moe-235b-a22b):
     a. flash attention at GQA 32/4 and 64/4 (head_dim 128) on phase 7's
        ragged set within rtol = atol = 1e-5 of its plain version, then at
        the MoE prefills' (4, 2048, 32/4, 128) and (4, 2048, 64/4, 128),
        causal, timed against the split-TF32 bound, the plain version and
        ``F.scaled_dot_product_attention``;
     b. ``launch.serve`` as phase 8 on qwen3-moe-30b-a3b at 24 of its 48
        layers and qwen3-moe-235b-a22b at 5 of its 94 (float32 weights of
        62.3 and 54.7 GB; all of them would be 122.1 and 940.4 GB), batch
        4, prompt 2048, 32 tokens, 2 rounds: launches exactly 49 / 11
        RMSNorm and 24 / 5 flash per prefill, none per decode step; the
        prefill's kernel route against the plain route within 2e-3 with
        the kernel route's routing decisions imposed on the plain route,
        the plain route's own differing decisions each on a near-tie
        within twice the two routes' probability difference
        (``MoeRouting``); each prefill's float32 products and rate, and
        the weight bytes a decode step reads;
     c. ``launch.train`` in phase 5's configuration on qwen3-moe-30b-a3b
        at full width, its depth and W the first cut of ``--layers 2`` at
        W = 2, ``--layers 3`` at W = 1 whose peak the dry-run reckons
        under 75 GB; lag-wk and laq@4, the peak in trees;
     d. both reduced configs from the same weights on the card and on the
        CPU: one layer's routing decisions equal (2 shards), the forward
        and the loss with its load-balance term, then 3 rounds of lag-wk:
        equal masks, losses within rtol 1e-4.

  18. bfloat16 serving (``get_config(arch, dtype="bfloat16",
     param_dtype="bfloat16", use_pallas=True)``, the reference's own
     bfloat16 config):
     a. the bfloat16 instantiations of RMSNorm (rows 1, 7, 129, 1000 and
        8192 at d 1024, 2048, 3072, 3584, 4096, 8192) and flash attention
        (phase 7's ragged set at head_dim 16, 32 (zero-padded to 64), 64,
        80, 128, 256 and GQA 64/4, 8/2, and at head_dim 16 and 32 in float32
        too; every registry prefill shape: phase 7's, 15a's, command-r-35b's
        (4, 2048, 64/8, 128), 16a's window, 17a's): RMSNorm bitwise the
        float32 kernel's row rounded twice, and within one bfloat16 ulp a
        rounding of the plain version on the widened inputs; flash within
        one bfloat16 ulp of the plain version on the widened inputs rounded
        to bfloat16; both within the reference's bfloat16 tolerances (3e-2,
        2.5e-2) of the plain bfloat16 versions.  Each full shape timed
        beside the float32 kernel on the widened inputs, the plain version
        and the library's bfloat16 call (RMSNorm in both dtypes by its three
        readings on a rotation of inputs and outputs larger than the 50 MB
        L2, so that every launch reads cold data, as phase 7; the times on
        one reused input beside them); flash's
        bound is the FLOP its masks leave at the bfloat16 tensor cores' 989
        TFLOP/s, the design's own work (one bfloat16 product for q·kᵀ,
        three for P·V) at the same rate beside it; command-r's shape also in
        float32.
     b. ``launch.serve`` as phase 8 at bfloat16: llama3.2-1b (the main
        path), command-r-35b at 40 of 40 layers, qwen3-moe-30b-a3b at 48 of
        48, qwen3-moe-235b-a22b at the most layers whose reckoned peak
        (weights + 8 GB) is under 75 GB, batch 4, prompt 2048, 32 tokens,
        2 rounds; recurrentgemma-9b at 2 × 4096; hubert-xlarge's forward,
        4 × 2048.  Launches exactly 2L + 1 ``rmsnorm_bf16`` and L
        ``flash_attention_bf16`` per prefill (hubert: L flash), none of the
        float32 ones, none per decode step; kernel route against plain route
        within the arch's BF16_ROUTE_BOUNDS (logits and every cache leaf;
        the MoE pair with ``MoeRouting``), the plain
        route's greedy tokens equal to the kernel route's where its top-2
        margin exceeds 4 × the routes' difference of the prefill logits
        (teacher-forced); where the float32 model fits
        (llama3.2-1b, recurrentgemma-9b, hubert), each route's bfloat16
        logits against the float32 logits on the widened weights, the
        kernel route's error within 2 × the plain route's.
     c. phase 5's lag-wk with ``remat=True``: losses and masks bitwise
        phase 5's (``remat=False``, the port's default), both runs'
        fwd/bwd and peak.
     d. every reduced config at bfloat16 from the same weights: forward and
        prefill on the card (the kernels) and on the CPU (plain), the
        card's error against the float32 model within 2 × the CPU's.

 19. bfloat16 training on the comm plane:
     a. kernels 1-4's bfloat16 instantiations (``kernels.ENTRIES``:
        (bf16, bf16) and (f32, bf16) operands) at phase 4's shapes, bitwise
        their plain versions (sums within 1e-5) and bitwise the float32
        kernels on the widened operands; ms, plain ms, byte bound, library
        call (``torch.addcmul`` for kernel 4);
     b. llama3.2-1b at bfloat16 (lag-wk, laq@4) and the float32 model with
        ``grad_hat_dtype="bfloat16"`` (lag-wk, laq@4) through ``init_state`` /
        ``make_train_step`` at full width and depth, W = 2, batch 4, seq
        256, 4 rounds, on the plane and on the card's plain route: masks
        equal, losses within 2 × BF16_ROUTE_LOSS_READINGS; ms, fwd/bwd,
        comm, peak
        and launches a round;
     c. command-r-35b at bfloat16, full width, at the depth
        ``repro_torch.launch.dryrun`` reckons under 75 GB (at W = 2, else
        W = 1: its untied head makes a one-layer tree 9.8 GB), 4 rounds of
        lag-wk;
     d. the dry-run's reckoned peak beside ``max_memory_allocated`` for
        19b, 19c and phase 5's float32 runs, the ratio within
        PEAK_RATIO_BAND.

 20. bfloat16 training of the mixed trees and the legacy route at bfloat16:
     a. the legacy kernels 8-12 at each new operand combination
        (``lag_trigger.ENTRIES``: (bf16, bf16), (f32, bf16), LAQ's residual
        float32; ``sqnorm_2d`` at bfloat16) at phase 9's shapes in bfloat16
        (llama3.2-1b's 11 full-width leaves, W = 2: one round's launches):
        bitwise their plain versions (sums within 1e-5) and bitwise the
        float32 kernel on the widened operands, sums included; ms, plain
        ms, byte bound and library call;
     b. the trees that keep float32 leaves, in bfloat16 at full width
        (mamba2-370m whole at W = 2, qwen3-moe-30b-a3b and
        recurrentgemma-9b at the depth and W the dry-run reckons under 75
        GB on every route, qwen3-moe-235b-a22b at one layer, W = 1, where
        the dry-run reckons it under 75 GB): lag-wk and laq@4 on the plane,
        on the legacy route and on the plain route, MIXED_STEPS rounds each,
        state in two parts; masks equal across the routes, |Δ loss| of each
        route against the plain route within 2 × MIXED_ROUTE_LOSS_READINGS,
        each route's measured peak over its reckoned one within
        PEAK_RATIO_BAND,
        and the launches a round by instantiation (plane lag-wk:
        ``delta_sqnorm_blocks_bb`` 1 + ``delta_sqnorm_blocks`` 1,
        ``masked_combine_bb`` 1 + ``masked_combine`` 1);
     c. llama3.2-1b at full width on the legacy route: bfloat16 lag-wk and
        laq@4, and the float32 model with ``grad_hat_dtype="bfloat16"``
        (lag-wk, laq@4): masks equal to 19b's plane runs, the new
        instantiations launched once a leaf a worker.

 21. bfloat16 training on the pods, async and fleet topologies, through
     ``init_state`` / ``make_train_step`` and ``fleet.init_fleet_state`` /
     ``make_fleet_step`` at full width and depth, batch 4, seq 256, 4
     rounds, weights from seed 0 (PHASE21): llama3.2-1b at bfloat16 on
     ``async:2@1`` (lag-wk, lag-ps; the float32 model with
     ``grad_hat_dtype="bfloat16"``, lag-wk), ``pods:2`` (lag-wk on the
     plane and the legacy route, laq@4 on the legacy route), ``fleet:4@2``
     (lag-wk, uniform and ``innovation`` with churn 0.25), ``fleet:2@1``
     (laq@4) and ``fleet:2@2`` (lag-wk, the full cohort); mamba2-370m
     whole at bfloat16 (its float32 leaves a part of their own) lag-wk on
     each topology.  Each run's exact launches a round per instantiation
     (``_bb``, ``_fb``, the float32 part; the legacy route's per leaf and
     worker), ms, device fwd/bwd and comm ms, state dtypes (a bfloat16 or
     ``Parts`` ring, float32 fleet rows) and peak (under 80 GB); the pods'
     and the full-cohort fleet's masks and losses bitwise 19b's shards runs;
     a checkpoint of mamba2-370m's async run (both parts) at round 2 saved,
     restored into a fresh state (other weights) and run to round 4,
     bitwise the uninterrupted run (masks, losses, θ), with save and
     restore seconds.

 22. float16 training and serving, and kernels 6-7 at every width and
     head_dim:
     a. the float16 instantiations of kernels 1-4 and 8-12 ((f16, f16)
        ``_hh``, (f32, f16) ``_fh``, ``sqnorm_2d_f16``) and kernel 5 at
        bfloat16 and float16, at phases 19a and 20a's shapes, on inputs
        that reach float16's subnormals and ±65504 (``f16_edges``):
        bitwise their plain versions (sums within 1e-5) and the float32
        kernels on the widened operands (kernel 5 read steadily: the
        median and min-max of 50 single launches, beside
        ``torch.linalg.vector_norm`` flat and per 1024-element
        sub-block); the float16 RMSNorm stream at d
        1024-8192 (bitwise the float32 kernel's row rounded twice) and
        timed at the prefill's shape; the rows RMSNorm kernel at
        RMS_ROWS_WIDTHS in all three dtypes (aligned, and contiguous rows
        one to three elements off an aligned base, which the stream's rule
        refuses), on the path ``rows_path`` names, and at RMS_STREAM_OFF
        one to three elements off, bitwise the stream's output; timed at
        (8192, d) for RMS_ROWS_TIMED beside ``F.rms_norm``; the float16
        flash kernel on the ragged sets at head_dim 64 and 256, on the
        dominant-key rows and at phase 18a's eight shapes (within one
        float16 ulp + 1e-6 of the widened plain version, rounded), each of
        those shapes timed beside f16 SDPA, its bound and the design's
        (1 + 2 float16 products); the wide flash kernel at
        ATTN_WIDE_RAGGED in all three dtypes on a ragged set and at
        ATTN_WIDE_HD; each timed beside its bound (float32: split TF32 and
        the FMA units'), plain version and library call;
     b. llama3.2-1b float16 through ``launch.serve`` with ``use_pallas=
        True`` (batch 4, prompt 2048, 32 tokens, 2 rounds): 33 RMSNorm and
        16 flash launches a prefill; kernel route vs plain route within 2 ×
        F16_ROUTE_READINGS, each against the float32 logits on the widened
        weights (the kernel route's error within 2 × the plain route's),
        greedy tokens;
     c. F16_TRAIN: llama3.2-1b float16 lag-wk and laq@4 on the plane, the
        legacy and the plain route, the float32 model with
        ``grad_hat_dtype="float16"`` (lag-wk, laq@4), mamba2-370m float16
        (float16 + float32 parts) whole, pods:2 and fleet:2@2: masks equal
        to the plane run's, |Δ loss| within 2 × F16_ROUTE_LOSS_READINGS
        (pods and fleet bitwise), finite losses, exact launches a round
        by instantiation, each peak within PEAK_RATIO_BAND of the
        dry-run's reckoning.
 23. the device plane (``devices:D``, ``repro_torch.devrun``):
     a. the wire format at llama3.2-1b's full-width layout: LAQ's codes at
        4 and 3 bits packed from the plane's own encode and unpacked, whole
        and row chunk by row chunk from a host copy, equal to the payload;
        a quiet slot all-zero; the dense wire the payload buffer itself;
     b. ``devices:1`` over NCCL in this process (a group of one rank that
        ``launch.train`` joins), lag-wk, 3 rounds, against ``shards:1``:
        masks, losses, θ and ĝ bitwise;
     c. ``devices:2`` over gloo, two spawned ranks sharing the card (the
        wire staged through host memory), phase 5's lag-wk and laq@4 on
        the plane, 3 rounds: masks and losses equal to phase 5's first 3,
        θ and each worker's ĝ bitwise its ``shards:2`` run's after them
        (bit digests), every round's counted collective bytes exactly the
        wire format's prediction, a fourth all-quiet lag-wk round (the
        history raised by 1e9) moving the mask and the losses alone; each rank's kernels 1-4
        launched every round, its launches added to the kernels line; ms a
        round, gather ms and peak GB a rank.
 24. the host mesh (``--mesh host``, ``repro_torch.dist.row_shards``: the
     LAG state row-sharded over the data ranks, θ whole):
     a. ``launch.train`` over NCCL in this process at one rank (a group of
        one that the launcher joins: the sharded code, its collectives
        local), phase 5's lag-wk, 3 rounds: masks, losses, θ and ĝ bitwise
        phase 5's first 3 rounds; ms a round beside phase 5's;
     b. two spawned gloo ranks sharing the card (collectives staged
        through host memory), llama3.2-1b at full width and 2 of 16 layers,
        W = 2, lag-wk and laq@4, 3 rounds each, against the one-process
        ``shards:2`` trainer at the same config run here first: masks and
        losses equal, θ and each rank's ĝ rows bitwise (bit digests); each
        round's collective records exactly ``sharding.row_shard_records``'
        prediction; kernels 1-4 launched every round on the ``(2, rows/2,
        128)`` shards, counted into the kernels line; each rank's peak GB
        beside the one-process run's.

Prints a ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``.  Times are CUDA-event times on this card (kernels: the mean of
several launches after a warm-up); bounds use the H100 SXM's published
3.35 TB/s, 67 TFLOP/s float32 (non-tensor) and 495 TFLOP/s dense TF32
peaks, and 989 TFLOP/s dense bfloat16.
"""
import contextlib
import gc
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
TF32_FLOP_PER_S = 495e12         # H100 SXM dense TF32 on the tensor cores
SUM_RTOL = 1e-5
RAGGED = (1, 127, 129, 32768, 0)
MODEL_TOL = 1e-5                 # kernel vs plain: f32, sums reordered
SERVE_TOL = 2e-3                 # kernel route vs plain route, all layers
REPLACES = {
    "delta_sqnorm_blocks": "src/repro/fastpath/kernels.py:130",
    "absmax_blocks": "src/repro/fastpath/kernels.py:142",
    "laq_encode_blocks": "src/repro/fastpath/kernels.py:168",
    "masked_combine": "src/repro/fastpath/kernels.py:214",
    "rmsnorm": "src/repro/kernels/rmsnorm/rmsnorm.py:25",
    "flash_attention": "src/repro/kernels/flash_attention/"
                       "flash_attention.py:68",
    "sqnorm_blocks": "src/repro/fastpath/kernels.py:137",
    "delta_sqnorm_2d": "src/repro/kernels/lag_trigger/lag_trigger.py:37",
    "sqnorm_2d": "src/repro/kernels/lag_trigger/lag_trigger.py:64",
    "masked_update_2d": "src/repro/kernels/lag_trigger/lag_trigger.py:87",
    "innovation_absmax_2d": "src/repro/kernels/lag_trigger/"
                            "lag_trigger.py:127",
    "laq_encode_2d": "src/repro/kernels/lag_trigger/lag_trigger.py:161",
}
# the bfloat16 instantiations of kernels 6 and 7: rows of their own
REPLACES.update({"rmsnorm_bf16": REPLACES["rmsnorm"],
                 "flash_attention_bf16": REPLACES["flash_attention"]})
# kernels 1-4's instantiations with a bfloat16 operand, named as in
# ``kernels.LAUNCHES``: (bf16, bf16) "_bb", (f32, bf16) "_fb"
REPLACES.update({k + sfx: REPLACES[k] for k in (
    "delta_sqnorm_blocks", "absmax_blocks", "laq_encode_blocks",
    "masked_combine") for sfx in ("_bb", "_fb")})
LEGACY_SOURCE = "src/repro_torch/kernels/lag_trigger/csrc/lag_trigger.cu"
# the legacy kernels' instantiations with a bfloat16 operand, named as in
# ``lag_trigger.LAUNCHES``
LEGACY_BF16 = tuple(k + sfx for k in (
    "delta_sqnorm_2d", "masked_update_2d", "innovation_absmax_2d",
    "laq_encode_2d") for sfx in ("_bb", "_fb")) + ("sqnorm_2d_bf16",)
REPLACES.update({k: REPLACES[k.rsplit("_", 1)[0]] for k in LEGACY_BF16})
SOURCES = {
    "rmsnorm": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/"
                       "flash_attention.cu",
    "rmsnorm_bf16": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
    "flash_attention_bf16": "src/repro_torch/kernels/flash_attention/csrc/"
                            "flash_attention_bf16.cu",
    **{k: LEGACY_SOURCE for k in ("delta_sqnorm_2d", "sqnorm_2d",
                                  "masked_update_2d", "innovation_absmax_2d",
                                  "laq_encode_2d") + LEGACY_BF16},
}
#: kernels that no path of the reference runs: their main-path launches
#: are 0, and the "never launched" checks exempt them by name
OFF_PATH = {
    "sqnorm_blocks": "nothing in src/repro calls FastPathPlan.sqnorm "
                     "(src/repro/fastpath/plan.py:160), only its tests",
    "delta_sqnorm_2d": "src/repro calls lag_trigger.ops.delta_sqnorm "
                       "nowhere; tests and benchmarks/perf_comm.py's "
                       "per-leaf baseline do",
    "masked_update_2d": "src/repro calls lag_trigger.ops."
                        "masked_lazy_update nowhere; its tests do",
}
OFF_PATH.update({k: OFF_PATH[k.rsplit("_", 1)[0]] for k in LEGACY_BF16
                 if k.rsplit("_", 1)[0] in OFF_PATH})
# phase 22: the float16 instantiations of kernels 1-5 and 8-12 (kernel 5 at
# bfloat16 too), kernel 6's float16 stream and its rows kernel in all three
# dtypes, kernel 7's float16 tensor-core kernel and its wide kernel in all
# three dtypes, each a row of its own, named as in the ``LAUNCHES`` tables
PLANE_F16 = tuple(k + sfx for k in (
    "delta_sqnorm_blocks", "absmax_blocks", "laq_encode_blocks",
    "masked_combine") for sfx in ("_hh", "_fh")) + (
    "sqnorm_blocks_bf16", "sqnorm_blocks_f16")
LEGACY_F16 = tuple(k + sfx for k in (
    "delta_sqnorm_2d", "masked_update_2d", "innovation_absmax_2d",
    "laq_encode_2d") for sfx in ("_hh", "_fh")) + ("sqnorm_2d_f16",)
RMS_ROWS = ("rmsnorm_rows", "rmsnorm_rows_bf16", "rmsnorm_rows_f16")
FLASH_WIDE = ("flash_attention_wide", "flash_attention_wide_bf16",
              "flash_attention_wide_f16")
REPLACES.update({k: REPLACES[k.rsplit("_", 1)[0]]
                 for k in PLANE_F16 + LEGACY_F16})
REPLACES.update({k: REPLACES["rmsnorm"] for k in ("rmsnorm_f16",)
                 + RMS_ROWS})
REPLACES.update({k: REPLACES["flash_attention"]
                 for k in ("flash_attention_f16",) + FLASH_WIDE})
SOURCES.update({k: LEGACY_SOURCE for k in LEGACY_F16})
SOURCES.update({k: SOURCES["rmsnorm"] for k in ("rmsnorm_f16",) + RMS_ROWS})
SOURCES.update({"flash_attention_f16": SOURCES["flash_attention_bf16"],
                "flash_attention_wide": SOURCES["flash_attention"],
                "flash_attention_wide_bf16": SOURCES["flash_attention_bf16"],
                "flash_attention_wide_f16": SOURCES["flash_attention_bf16"]})
OFF_PATH.update({k: OFF_PATH[k.rsplit("_", 1)[0]]
                 for k in PLANE_F16 + LEGACY_F16
                 if k.rsplit("_", 1)[0] in OFF_PATH})
OFF_PATH.update({k: "no configuration of the repo has a row the stream "
                    "kernel does not take (every d a multiple of 4, at most "
                    "8192): phase 22a drives it" for k in RMS_ROWS})
OFF_PATH.update({k: "no configuration of the repo has a head_dim above "
                    "256: phase 22a drives it" for k in FLASH_WIDE})
LEGACY_SIZES = (1, 3, 127, 129, 1000, 257 * 33, 32768, 32769)
SOURCE = "src/repro_torch/fastpath/csrc/fastpath_kernels.cu"
SERVE_ARGS = ["--arch", "llama3.2-1b", "--batch", "4", "--prompt-len", "2048",
              "--gen", "32", "--rounds", "2", "--seed", "0"]
RMS_FULL = (4 * 2048, 2048)      # the prefill's (B·S, d)
# flash attention's ragged cases: S on and around its 64-row / 64-key tile
# edges, windows that straddle tiles, Sq != Skv both ways
FLASH_S = (1, 7, 63, 64, 65, 127, 128, 129, 1000, 2047)
FLASH_MASKS = ((True, None), (True, 16), (True, 64), (True, 100),
               (False, None))
FLASH_CROSS = [(129, 1000, False, None), (129, 1000, True, None),
               (1000, 129, True, 64), (65, 200, True, None),
               (200, 65, True, None), (200, 65, True, 100),
               (64, 130, False, 16)]
ATTN_FULL = (4, 2048, 32, 8, 64)  # the prefill's (B, S, H, KV, hd)
# phase 6: (algo, legacy per-leaf route, lr) on the reduced model
AGREEMENT_RUNS = (("lag-wk", False, 0.3), ("laq@4", False, 0.3),
                  ("lag-wk", True, 0.3), ("laq@4", True, 0.3),
                  ("lasg-wk", False, 0.3), ("lasg-wk", True, 0.3),
                  ("cyc-laq@4", False, 0.3), ("lag-adam", False, 1e-3))
# phase 11: (algo, legacy route, extra launcher flags, the plane's kernels
# and their least launches a round; {} = none of the plane's at all)
PHASE11 = (
    ("lasg-wk", False, (), {"delta_sqnorm_blocks": 1, "masked_combine": 2}),
    ("lasg-wk", True, (), {}),
    ("cyc-iag", False, (), {}),
    ("num-iag", False, (), {}),
    ("cyc-laq@4", False, (), {"absmax_blocks": 1, "laq_encode_blocks": 1,
                              "masked_combine": 2}),
    ("lag-adam", False, ("--lr", "1e-3"),
     {"delta_sqnorm_blocks": 1, "masked_combine": 1}),
    ("lag-wk", False, ("--server", "momentum@0.9"),
     {"delta_sqnorm_blocks": 1, "masked_combine": 1}),
    ("lag-wk", False, ("--server", "prox-l1@1e-6"),
     {"delta_sqnorm_blocks": 1, "masked_combine": 1}),
)

# phase 12: the convex simulation.  Fig. 3's reference numbers (the live
# JAX reference in float64, ε = 1e-8): iterations, uploads and bytes to ε
# per algo.  laq's and num-iag's are the reference's XLA-CPU quantizer and
# jax.random draw, which the port does not make (ROADMAP queue 3): those
# two are held to the port's own CPU run.
CONVEX_TABLE = {"gd": (62, 567, 226800.0), "lag-wk": (66, 122, 48800.0),
                "lag-ps": (78, 153, 61200.0), "lasg-wk": (66, 122, 48800.0),
                "laq": (65, 162, 4698.0), "cyc-iag": (555, 556, 222400.0),
                "num-iag": (528, 529, 211600.0)}
CONVEX_OWN = ("laq", "num-iag")
# 12b: the plane's kernels each float32 spec launches every round
CONVEX_PLANE = {
    "lag-wk": {"delta_sqnorm_blocks": 1, "masked_combine": 1},
    "lag-ps": {"delta_sqnorm_blocks": 1, "masked_combine": 2},
    "lasg-wk": {"delta_sqnorm_blocks": 1, "masked_combine": 2},
    "laq@4": {"absmax_blocks": 1, "laq_encode_blocks": 1,
              "masked_combine": 2},
    "cyc-laq@4": {"absmax_blocks": 1, "laq_encode_blocks": 1,
                  "masked_combine": 2},
}
# 12b: the float32 runs' ε (their loss gap floor is near 1e-5); LAQ's codes
# turn last-bit differences of the two devices' matrix products into whole
# quantizer steps, so its triggered masks are compared through 1e-1 and its
# losses within 1e-3 (the parity tests' float32 LAQ bounds)
CONVEX_EPS32, CONVEX_RTOL32 = 1e-4, 1e-5
LAQ_EPS32, LAQ_RTOL32 = 1e-1, 1e-3
# 12a: float64 losses on the card against the CPU's (the two devices' float64
# products add in different orders)
CONVEX_RTOL64 = 1e-12
# 12d: past the optimum the triggers compare round-off, so the priced tail
# may differ.  Readings of lag-wk's wall_seconds at K 600 (hetero:9@10ms/
# 1Gbps, h 0.8): the card against the port's CPU run 30.6046848 against
# 30.6043264 s (rtol 1.2e-5, NVIDIA H100 80GB HBM3); the port's CPU run
# against the JAX reference's, both on a CPU, 30.6043264 against 30.6132864
# s (rtol 2.9e-4: 418 rounds from round 182, where the loss is within
# 8.9e-16 of the optimum, upload differently).  The check allows 1e-3.
WALL_RTOL = 1e-3
# phase 13: (part, algo, launcher flags, the plane's kernels and their exact
# launches a round) at full width; a fleet adds one delta_sqnorm_blocks a
# round for the cohort's innovation ‖∇L_m − ĝ_m‖²
PHASE13 = (
    ("13a", "lag-wk", ("--topology", "async:2@1"),
     {"delta_sqnorm_blocks": 1, "masked_combine": 1}),
    ("13a", "lag-ps", ("--topology", "async:2@1"),
     {"delta_sqnorm_blocks": 1, "masked_combine": 2}),
    ("13b", "lag-wk", ("--topology", "pods:2"),
     {"delta_sqnorm_blocks": 1, "masked_combine": 1}),
    ("13c", "lag-wk", ("--topology", "fleet:4@2"),
     {"delta_sqnorm_blocks": 2, "masked_combine": 1}),
    ("13c", "lag-wk", ("--topology", "fleet:4@2", "--fleet-selection",
                       "innovation", "--fleet-churn", "0.25"),
     {"delta_sqnorm_blocks": 2, "masked_combine": 1}),
    ("13c", "laq@4", ("--topology", "fleet:2@1"),
     {"delta_sqnorm_blocks": 1, "absmax_blocks": 1, "laq_encode_blocks": 1,
      "masked_combine": 2}),
)
# 13d: BENCH_fleet.json's scale row (N, k, K) and the kernels a round
FLEET_SCALE = (10_000, 625, 300)
CONVEX_FLEET_PLANE = {"delta_sqnorm_blocks": 2, "masked_combine": 1}
# 13d compares masks through the CPU run's iters_to(1e-2).  On the port's
# own draws the gap reaches 1e-2 at round 250 and never 1e-4 in 300 rounds
# (1.7e-3 at round 299; the CPU run, fastpath "on"); on an H100 80GB HBM3
# (700 W) the card's masks equal the CPU's through round 261 (gap 5e-3)
# and a trigger flips at 262: past that point the
# triggers of 625 clients compare the two devices' float32 round-off
# (kernel 1's partial sums agree with the plain version's within rtol 1e-5,
# not bitwise), as in 12b past its ε
CONVEX_FLEET_EPS = 1e-2
# 12c's Gisette data (10 eigvalsh of 4837 x 4837, 26-32 s) and 13d's CPU run
# (300 rounds at 226-321 ms) need no card: each runs in a CPU-only process
# of its own (``cpu_child``), started after the build, beside phases 3-13,
# with this many threads; what it returns is pickled back
CPU_CHILD_THREADS = 3
GISETTE = dict(n=2000, d=4837, lam=1e-3)
# phase 14a: (algo, the plane's kernels and their exact launches a round)
# on graph:2@ring at full width
PHASE14A = (
    ("lag-wk", {"delta_sqnorm_blocks": 1, "masked_combine": 1}),
    ("laq@4", {"absmax_blocks": 1, "laq_encode_blocks": 1,
               "masked_combine": 2}),
)
# 14c: benchmarks/graph_sweep.py's problem and algos, and the kernels each
# float32 algo launches a round on the plane (gd opts out: none)
GRAPH_PROBLEM = dict(num_workers=9, n_per=20, d=10, seed=0)
GRAPH_FAMILIES = ("ring", "torus:3x3")
GRAPH_PLANE = {"gd": {}, "lag-wk": PHASE14A[0][1], "laq@4": PHASE14A[1][1]}
GRAPH_K = 400


# phase 15: the dense block kind
DENSE_KIND = ("llama3.2-3b", "llama3.2-1b-sw", "granite-8b", "command-r-35b",
              "qwen2-vl-7b", "hubert-xlarge")
# 15a: (head_dim, H, KV) of the ragged set; the new archs' prefill shapes
# (B, S, H, KV, hd, causal); their RMSNorm widths
WIDE_RAGGED = ((80, 16, 16), (128, 24, 8))
ATTN_WIDE = ((4, 2048, 24, 8, 128, True), (4, 2048, 28, 4, 128, True),
             (4, 2048, 16, 16, 80, False))
RMS_WIDE = (3072, 3584, 4096, 8192)
# 15b: (arch, serve flags, layers kept: None = all); command-r-35b's 40
# layers take 129.5 GB in float32, its 12 with embed and head 50.6 GB
SERVE_WIDE = (
    ("llama3.2-3b", SERVE_ARGS[2:], None),
    ("granite-8b", SERVE_ARGS[2:], None),
    ("qwen2-vl-7b", SERVE_ARGS[2:], None),
    ("command-r-35b", SERVE_ARGS[2:], 12),
    ("llama3.2-1b-sw", ["--batch", "2", "--prompt-len", "6144", "--gen",
                        "32", "--rounds", "2", "--seed", "0"], None),
)
HUBERT_FORWARD = (4, 2048)       # 15c: (batch, frames)
# 15d: (arch, algo, launcher flags)
TRAIN_WIDE = (("hubert-xlarge", "lag-wk", ()),
              ("hubert-xlarge", "laq@4", ()),
              ("qwen2-vl-7b", "lag-wk", ("--layers", "2")))

# phase 16: the recurrent and state-space kinds
# 16a: (H, KV) of the ragged set at head_dim 256; recurrentgemma's prefill
# shape (B, S, H, KV, hd, window), causal
HD256_RAGGED = ((16, 1), (8, 2))
ATTN_HD256 = (2, 4096, 16, 1, 256, 2048)
# 16b: (arch, serve flags); 4096 > recurrentgemma's window of 2048, and
# mamba2's 2048 tokens are 8 chunks of 256
SERVE_RECURRENT = (
    ("recurrentgemma-9b", ["--batch", "2", "--prompt-len", "4096", "--gen",
                           "32", "--rounds", "2", "--seed", "0"]),
    ("mamba2-370m", SERVE_ARGS[2:]),
)
# 16c: recurrentgemma's training cuts (layers, workers) in order of
# preference, and the peak the dry-run (``repro_torch.launch.dryrun``)
# must reckon a cut under
TRAIN_CUTS = ((5, 2), (5, 1), (3, 1))
TRAIN_RECKON_GB = 75.0

# phase 17: the moe kind
MOE_KIND = ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b")
# 17a: the MoE archs' prefill shapes (B, S, H, KV, hd), causal: each KV
# head serves 8 and 16 query heads
ATTN_MOE = ((4, 2048, 32, 4, 128), (4, 2048, 64, 4, 128))
# 17b: (arch, layers kept of 48 / 94): a layer is 2.49 / 9.95 GB in
# float32, embed and head 2.49 / 4.98 GB, so 62.3 / 54.7 GB of weights
SERVE_MOE = (("qwen3-moe-30b-a3b", 24), ("qwen3-moe-235b-a22b", 5))
# 17c: qwen3-moe-30b-a3b's training cuts (layers, workers) in order of
# preference, each reckoned by the dry-run
MOE_TRAIN_CUTS = ((2, 2), (3, 1))

# phase 18: bfloat16 serving, ``get_config(arch, **BF16, use_pallas=True)``
BF16 = dict(dtype="bfloat16", param_dtype="bfloat16")
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bfloat16 on the tensor cores
# 18a: RMSNorm's registry widths (mamba2 1024, llama3.2-1b and 30b-a3b 2048,
# llama3.2-3b 3072, qwen2-vl 3584, granite / recurrentgemma / 235b-a22b
# 4096, command-r 8192); flash at every registry prefill shape (B, S, H, KV,
# hd, causal, window): phase 7's, 15a's three, command-r-35b's, 16a's, 17a's
# two; the ragged set at each head_dim (and GQA 64/4, 8/2)
BF16_RMS_WIDTHS = (1024, 2048, 3072, 3584, 4096, 8192)
ATTN_BF16 = ((4, 2048, 32, 8, 64, True, None),
             (4, 2048, 24, 8, 128, True, None),
             (4, 2048, 28, 4, 128, True, None),
             (4, 2048, 16, 16, 80, False, None),
             (4, 2048, 64, 8, 128, True, None),
             (2, 4096, 16, 1, 256, True, 2048),
             (4, 2048, 32, 4, 128, True, None),
             (4, 2048, 64, 4, 128, True, None))
BF16_RAGGED = ((16, 8, 2), (32, 8, 2), (64, 32, 8), (80, 16, 16),
               (128, 24, 8), (128, 64, 4), (256, 16, 1), (256, 8, 2))
# 18a: head_dims below every instantiation (the reference's own test cases
# run 16 and 32), zero-padded to 64: (head_dim, H, KV) in float32
PADDED_RAGGED = ((16, 8, 2), (32, 8, 2))
# 18a: RMSNorm's timed launches rotate through inputs and outputs of at
# least this many bytes together, 4 x the H100's 50 MB L2
COLD_BYTES = 200e6
# RMSNorm's device-only reading (phases 7, 15a, 18a): the sleep ahead of a
# timed loop lasts this many times the loop's host time, counted at a clock
# no H100 exceeds (its boost clock is 1.98 GHz), so it is never shorter
HOLD_FACTOR = 3
HOLD_CLOCK_HZ = 2.0e9
# 18b: (arch, serve flags, layers kept: None = all, "reckon" = the most
# under SERVE_RECKON_GB; the float32 model fits beside it).  bfloat16
# weights: command-r-35b 64.76 GB at 40 layers, qwen3-moe-30b-a3b 61.09 at
# 48, recurrentgemma-9b 19.26
SERVE_BF16 = (
    ("llama3.2-1b", SERVE_ARGS[2:], None, True),
    ("command-r-35b", SERVE_ARGS[2:], 40, False),
    ("qwen3-moe-30b-a3b", SERVE_ARGS[2:], 48, False),
    ("qwen3-moe-235b-a22b", SERVE_ARGS[2:], "reckon", False),
    ("recurrentgemma-9b", SERVE_RECURRENT[0][1], None, True),
)
# 18b: a serving peak reckoned as its weights + SERVE_ACT_GB: phase 17b's
# float32 serving peaks sit 4.3 / 5.6 GB above their weights (H100 80GB
# HBM3, 700 W), 8 GB is that with room; the reckoned peak must stay under
# SERVE_RECKON_GB
SERVE_ACT_GB = 8.0
SERVE_RECKON_GB = 75.0
# 18a: the reference's bfloat16 tolerances for its kernels against its plain
# versions (tests/test_kernels.py: RMSNorm 3e-2, flash 2.5e-2), stated for
# its test inputs, whose outputs are of order one; here × the output's
# largest |entry| where that exceeds one (at |x| >= 8 one bfloat16 ulp is
# 6.25e-2).  The binding checks are the one-ulp ones
REF_RMS_TOL, REF_FLASH_TOL = 3e-2, 2.5e-2
# 18b/d: the two routes in bfloat16.  The plain route rounds the attention
# scores and weights to bfloat16 between its products (as the reference's
# plain route does), the kernel holds them in float32, so the routes part
# by bfloat16 rounding carried through every layer.  Against the float32
# model, where it fits, the kernel route's error must stay within
# BF16_ERR_RATIO × the plain route's (the CPU tests' ratio).  Between the
# routes, per arch: logits and each cache leaf within BF16_ROUTE_FACTOR ×
# that arch's max |kernel − plain| read in this phase (H100 80GB HBM3,
# 700 W; the routes are deterministic, so a reading moves only when the
# code does).  Their float32 errors, where float32 fits, are no smaller:
# llama3.2-1b 0.0658, recurrentgemma-9b 0.279, hubert-xlarge 0.0657.  The
# plain route's greedy tokens, teacher-forced on the kernel route's, equal
# wherever its top-2 margin exceeds BF16_MARGIN × the two routes' measured
# difference of the prefill logits
BF16_ERR_RATIO = 2.0
BF16_ROUTE_FACTOR = 2.0
BF16_ROUTE_READINGS = {
    "llama3.2-1b": {"logits": 0.0625, "k cache": 0.0625,
                    "v cache": 0.0625},
    "command-r-35b": {"logits": 0.07812, "k cache": 0.08594,
                      "v cache": 0.08594},
    "qwen3-moe-30b-a3b": {"logits": 0.04688, "k cache": 0.0625,
                          "v cache": 0.06348},
    "qwen3-moe-235b-a22b": {"logits": 0.03125, "k cache": 0.04688,
                            "v cache": 0.04688},
    "recurrentgemma-9b": {"logits": 0.1719, "conv cache": 0.1631,
                          "h cache": 0.03729, "k cache": 0.1895,
                          "v cache": 0.1898},
    "hubert-xlarge": {"logits": 0.0752},
}
BF16_MARGIN = 4.0

# phase 19: bfloat16 training on the comm plane
# 19a: each bfloat16 instantiation of kernels 1-4 at phase 4's shapes; the
# combinations are the plane's (``kernels.ENTRIES``): (bf16, bf16) a
# bfloat16 model's buffers, (f32, bf16) a float32 model's gradients against
# bfloat16 ĝ; each its own row of the kernels line (its ``LAUNCHES`` name)
BF16_COMBOS = {"bf16-bf16": "_bb", "f32-bf16": "_fb"}
# 19b/19c: the trainings (cfg kwargs, TrainerConfig kwargs) on llama3.2-1b
# at full width and depth (W = 2, batch 4, seq 256, 4 rounds), each against
# the same run on the card's plain route (``make_policy(fastpath=None)``)
BF16_TRAIN = (("llama3.2-1b", BF16, dict(algo="lag-wk")),
              ("llama3.2-1b", BF16, dict(algo="laq@4")),
              ("llama3.2-1b", {}, dict(algo="lag-wk",
                                        grad_hat_dtype="bfloat16")),
              ("llama3.2-1b", {}, dict(algo="laq@4",
                                        grad_hat_dtype="bfloat16")))
BF16_TRAIN_RECKON_GB = 75.0
# 19b: plane against plain route on the card, masks equal and the largest
# |Δ loss| over 4 rounds within BF16_ROUTE_FACTOR × its reading (H100 80GB
# HBM3, 700 W; 0: bitwise).  lag-wk does the same arithmetic on both
# routes; a float32 payload folds into a bfloat16 ĝ with one rounding on
# the plane, two on the plain route (the reference's two routes alike,
# ROADMAP queue 3), and the trajectories part from round 1
BF16_ROUTE_LOSS_READINGS = {"lag-wk": 0.0, "laq@4": 8.869e-05,
                            "lag-wk grad_hat_dtype=bfloat16": 2.861e-06,
                            "laq@4 grad_hat_dtype=bfloat16": 3.91e-05}
# 19d: measured peak (torch.cuda.max_memory_allocated) over the dry-run's
# reckoned peak; the band from the first reading (H100 80GB HBM3, 700 W:
# 1.0009-1.0031 over 19b, 19c and phase 5)
PEAK_RATIO_BAND = (0.98, 1.02)

# phase 20: bfloat16 training of the mixed trees and the legacy route at
# bfloat16
# 20a: the legacy kernels' new instantiations, named as in
# ``lag_trigger.LAUNCHES``: (bf16, bf16) "_bb", (f32, bf16) "_fb", one
# bfloat16 operand "_bf16"
LEGACY_COMBOS = {"bf16-bf16": "_bb", "f32-bf16": "_fb"}
# 20b: the mixed trees: (arch, fixed (layers, workers), or None for the
# depth and W the dry-run reckons under MIXED_RECKON_GB, W = 2 first)
MIXED_TRAIN = (("mamba2-370m", (48, 2)), ("qwen3-moe-30b-a3b", None),
               ("recurrentgemma-9b", None), ("qwen3-moe-235b-a22b", (1, 1)))
MIXED_RECKON_GB = 75.0
# 20b: laq@4's plain and legacy routes hold float32 trees the plane folds in
# place: their peak is about 1.28× the plane's (19b, llama3.2-1b bfloat16:
# 56.92 against 44.60 GB, H100 80GB HBM3, 700 W).  laq@4's first depth is
# the one whose reckoned plane peak is under MIXED_RECKON_GB /
# MIXED_LAQ_ROUTE_RATIO; then the dry-run reckons every route at it, one
# layer fewer while one of them is not under MIXED_RECKON_GB
MIXED_LAQ_ROUTE_RATIO = 1.28
MIXED_STEPS = 3
ROUTES = ("plane", "legacy", "plain")
# 20b: each route against the plain route on the card, masks equal and the
# largest |Δ loss| over MIXED_STEPS rounds within BF16_ROUTE_FACTOR × its
# reading (0: bitwise; H100 80GB HBM3, 700 W).  lag-wk does the same
# arithmetic on every route; the legacy kernels are bitwise their plain
# versions, so the legacy route is the plain route's arithmetic.  laq@4's
# float32 payload folds into the bfloat16 ĝ with one rounding on the plane,
# two on the plain route (ROADMAP queue 3 (e)); the first ĝ that differs is
# round 1's fold, which enters round 2's payload and round 3's loss, so in
# three rounds the losses are bitwise too
MIXED_ROUTE_LOSS_READINGS = {"lag-wk plane": 0.0, "lag-wk legacy": 0.0,
                             "laq@4 plane": 0.0, "laq@4 legacy": 0.0}

# phase 21: bfloat16 training on the topologies: (arch, cfg kwargs,
# TrainerConfig kwargs, topology, fleet churn, fleet selection, route, the
# launches a round by instantiation, the 19b plane run whose masks (and, at
# "bitwise", losses) the run reproduces).  The legacy route launches its
# kernels once a leaf a worker (llama3.2-1b: 11 leaves, W = 2); a fleet adds
# kernel 1 once a part for the cohort's innovation ‖∇L_m − ĝ_m‖²
_L22 = 22
PHASE21 = (
    ("llama3.2-1b", BF16, dict(algo="lag-wk"), "async:2@1", 0.0, "uniform",
     "plane", {"delta_sqnorm_blocks_bb": 1, "masked_combine_bb": 1}, None),
    ("llama3.2-1b", BF16, dict(algo="lag-ps"), "async:2@1", 0.0, "uniform",
     "plane", {"delta_sqnorm_blocks_bb": 1, "masked_combine_bb": 2}, None),
    ("llama3.2-1b", {}, dict(algo="lag-wk", grad_hat_dtype="bfloat16"),
     "async:2@1", 0.0, "uniform", "plane",
     {"delta_sqnorm_blocks_fb": 1, "masked_combine_fb": 1}, None),
    ("llama3.2-1b", BF16, dict(algo="lag-wk"), "pods:2", 0.0, "uniform",
     "plane", {"delta_sqnorm_blocks_bb": 1, "masked_combine_bb": 1},
     ("llama3.2-1b bfloat16 lag-wk", "bitwise")),
    ("llama3.2-1b", BF16, dict(algo="lag-wk"), "pods:2", 0.0, "uniform",
     "legacy", {"sqnorm_2d_bf16": _L22},
     ("llama3.2-1b bfloat16 lag-wk", "bitwise")),
    ("llama3.2-1b", BF16, dict(algo="laq@4"), "pods:2", 0.0, "uniform",
     "legacy", {"innovation_absmax_2d_bb": _L22, "laq_encode_2d_bb": _L22},
     ("llama3.2-1b bfloat16 laq@4", "masks")),
    ("llama3.2-1b", BF16, dict(algo="lag-wk"), "fleet:4@2", 0.0, "uniform",
     "plane", {"delta_sqnorm_blocks_bb": 2, "masked_combine_bb": 1}, None),
    ("llama3.2-1b", BF16, dict(algo="lag-wk"), "fleet:4@2", 0.25,
     "innovation", "plane",
     {"delta_sqnorm_blocks_bb": 2, "masked_combine_bb": 1}, None),
    ("llama3.2-1b", BF16, dict(algo="laq@4"), "fleet:2@1", 0.0, "uniform",
     "plane", {"delta_sqnorm_blocks_bb": 1, "absmax_blocks_bb": 1,
               "laq_encode_blocks_bb": 1, "masked_combine_fb": 1,
               "masked_combine": 1}, None),
    ("llama3.2-1b", BF16, dict(algo="lag-wk"), "fleet:2@2", 0.0, "uniform",
     "plane", {"delta_sqnorm_blocks_bb": 2, "masked_combine_bb": 1},
     ("llama3.2-1b bfloat16 lag-wk", "bitwise")),
    ("mamba2-370m", BF16, dict(algo="lag-wk"), "pods:2", 0.0, "uniform",
     "plane", {"delta_sqnorm_blocks_bb": 1, "delta_sqnorm_blocks": 1,
               "masked_combine_bb": 1, "masked_combine": 1}, None),
    ("mamba2-370m", BF16, dict(algo="lag-wk"), "async:2@1", 0.0, "uniform",
     "plane", {"delta_sqnorm_blocks_bb": 1, "delta_sqnorm_blocks": 1,
               "masked_combine_bb": 1, "masked_combine": 1}, None),
    ("mamba2-370m", BF16, dict(algo="lag-wk"), "fleet:4@2", 0.0, "uniform",
     "plane", {"delta_sqnorm_blocks_bb": 2, "delta_sqnorm_blocks": 2,
               "masked_combine_bb": 1, "masked_combine": 1}, None),
)
# 21: the run checkpointed at round PHASE21_CKPT_AT and resumed: mamba2's
# async run, a state of both parts (about 4.4 GB; llama3.2-1b's async state
# is 14.83 GB, 54 s to save and restore on an H100 80GB HBM3, 700 W)
PHASE21_CKPT = ("mamba2-370m", "async:2@1")
PHASE21_CKPT_AT = 2

# phase 22: float16 training and serving, kernels 6 and 7 at every width and
# head_dim (``get_config(arch, **F16)``)
F16 = dict(dtype="float16", param_dtype="float16")
# 22a: the float16 instantiations of kernels 1-4 and 8-12, named as in
# ``kernels.LAUNCHES`` / ``lag_trigger.LAUNCHES``: (f16, f16) "_hh", (f32,
# f16) "_fh"
F16_COMBOS = {"f16-f16": "_hh", "f32-f16": "_fh"}
# 22a: the rows RMSNorm kernel's widths (not 8-byte rows, and wider than the
# stream's 8192), the two timed at (8192, d), the first in the kernels line
RMS_ROWS_WIDTHS = (1, 3, 17, 4099, 8200, 16384, 20000)
RMS_ROWS_TIMED = (4099, 20000)
# 22a: widths the stream takes, given to the rows kernel 1 to 3 elements
# off an aligned base
RMS_STREAM_OFF = (132, 2048, 8192)
# 22a: the wide flash kernel's timed shapes (B, S, H, KV, hd, causal,
# window), the first in the kernels line
ATTN_WIDE_HD = ((2, 2048, 16, 4, 320, True, None),
                (2, 2048, 16, 4, 512, True, None))
# 22a: the wide kernel's ragged head_dims: padded to 8 (257), each
# instantiation (320, 512), slabs above 512 (600)
ATTN_WIDE_RAGGED = (257, 320, 512, 600)
# 22b: the two routes in float16, held as BF16_ROUTE_READINGS holds them
# (the kernel route's error against the float32 logits within
# BF16_ERR_RATIO × the plain route's; logits and cache within
# BF16_ROUTE_FACTOR × these readings: H100 80GB HBM3, 700 W, the first
# phase 22 run; the routes are deterministic)
F16_ROUTE_READINGS = {
    "llama3.2-1b": {"logits": 0.007812, "k cache": 0.007812,
                    "v cache": 0.007812},
}
# 22c: (arch, cfg kwargs, TrainerConfig kwargs, route or topology, the
# launches a round by instantiation) on llama3.2-1b at full width and depth
# and mamba2-370m whole, W = 2, batch 4, seq 256, 4 rounds.  The first run
# of a label is its plane run; the others are held to it: masks equal, the
# largest |Δ loss| within BF16_ROUTE_FACTOR × F16_ROUTE_LOSS_READINGS, or
# bit for bit on pods:2 and fleet:2@2
_LW, _LQ = dict(algo="lag-wk"), dict(algo="laq@4")
_GW = dict(algo="lag-wk", grad_hat_dtype="float16")
_GQ = dict(algo="laq@4", grad_hat_dtype="float16")
F16_TRAIN = (
    ("llama3.2-1b", F16, _LW, "plane",
     {"delta_sqnorm_blocks_hh": 1, "masked_combine_hh": 1}),
    ("llama3.2-1b", F16, _LW, "legacy", {"sqnorm_2d_f16": _L22}),
    ("llama3.2-1b", F16, _LW, "plain", {}),
    ("llama3.2-1b", F16, _LW, "pods:2",
     {"delta_sqnorm_blocks_hh": 1, "masked_combine_hh": 1}),
    ("llama3.2-1b", F16, _LW, "fleet:2@2",
     {"delta_sqnorm_blocks_hh": 2, "masked_combine_hh": 1}),
    ("llama3.2-1b", F16, _LQ, "plane",
     {"absmax_blocks_hh": 1, "laq_encode_blocks_hh": 1,
      "masked_combine_fh": 1, "masked_combine": 1}),
    ("llama3.2-1b", F16, _LQ, "legacy",
     {"innovation_absmax_2d_hh": _L22, "laq_encode_2d_hh": _L22}),
    ("llama3.2-1b", F16, _LQ, "plain", {}),
    ("llama3.2-1b", {}, _GW, "plane",
     {"delta_sqnorm_blocks_fh": 1, "masked_combine_fh": 1}),
    ("llama3.2-1b", {}, _GW, "plain", {}),
    ("llama3.2-1b", {}, _GQ, "plane",
     {"absmax_blocks_fh": 1, "laq_encode_blocks_fh": 1,
      "masked_combine_fh": 1, "masked_combine": 1}),
    ("llama3.2-1b", {}, _GQ, "legacy",
     {"innovation_absmax_2d_fh": _L22, "laq_encode_2d_fh": _L22}),
    ("mamba2-370m", F16, _LW, "plane",
     {"delta_sqnorm_blocks_hh": 1, "delta_sqnorm_blocks": 1,
      "masked_combine_hh": 1, "masked_combine": 1}),
)
# 22c: each route's largest |Δ loss| against its label's plane run over 4
# rounds (H100 80GB HBM3, 700 W, the first phase 22 run; 0: bitwise).
# lag-wk does the same arithmetic on every route; LAQ's float32 payload
# folds into the float16 ĝ with one rounding on the plane, two on the
# legacy and plain routes (as in bfloat16, 19b), and the trajectories part
# from round 1's fold
F16_ROUTE_LOSS_READINGS = {
    "llama3.2-1b float16 lag-wk legacy": 0.0,
    "llama3.2-1b float16 lag-wk plain": 0.0,
    "llama3.2-1b float16 laq@4 legacy": 1.431e-05,
    "llama3.2-1b float16 laq@4 plain": 1.431e-05,
    "llama3.2-1b float32 lag-wk grad_hat_dtype=float16 plain": 1.907e-06,
    "llama3.2-1b float32 laq@4 grad_hat_dtype=float16 legacy": 3.91e-05,
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_ms(torch, fn, n=5, warmup=1):
    """Mean CUDA-event time of ``fn`` over ``n`` runs after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def steady_ms(torch, fn, n=50):
    """``n`` single-launch CUDA-event readings after one warm launch →
    (median, min, max) ms: a reading that one slow launch does not move."""
    fn()
    torch.cuda.synchronize()
    evs = [(torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for a, b in evs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    t = sorted(a.elapsed_time(b) for a, b in evs)
    return t[n // 2] if n % 2 else (t[n // 2 - 1] + t[n // 2]) / 2, t[0], \
        t[-1]


def steady_line(r):
    return f"{r[0]:.4f} ms ({r[1]:.4f}–{r[2]:.4f})"


def cold_ms(torch, fn, inputs, n=50):
    """Mean CUDA-event time of ``fn`` over ``n`` launches that rotate
    through ``inputs`` (each launch's output kept until its slot comes
    round again), after a warm-up round: with the rotation's bytes above
    the L2 cache, every launch reads data that no recent launch left
    there."""
    outs = [fn(*x) for x in inputs]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        j = i % len(inputs)
        outs[j] = fn(*inputs[j])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def held_ms(torch, fn, inputs, n=50):
    """Device-only and host readings of ``cold_ms``'s loop.  The ``n``
    launches are queued behind ``torch.cuda._sleep``, which lasts
    HOLD_FACTOR × the loop's own host time (at HOLD_CLOCK_HZ, at least the
    card's clock, so never shorter): the host has enqueued every launch
    before the device reaches the first, which ``query()`` on the start
    event confirms, and the two events time device work alone.  The
    loop's ``time.perf_counter`` time while the device sleeps is the host's
    µs per call.  → (device ms per call, host µs per call)."""
    outs = [fn(*x) for x in inputs]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        j = i % len(inputs)
        outs[j] = fn(*inputs[j])
    loop_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(HOLD_FACTOR * loop_s * HOLD_CLOCK_HZ) + 100000)
        start.record()
        t0 = time.perf_counter()
        for i in range(n):
            j = i % len(inputs)
            outs[j] = fn(*inputs[j])
        host_s = time.perf_counter() - t0
        held = not start.query()       # still sleeping: all n were queued
        end.record()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / n, host_s / n * 1e6
        loop_s = max(2 * loop_s, host_s)
    raise RuntimeError("chip_smoke check failed: the sleep never outlasted "
                       "the host's enqueue loop")


def rms_readings(torch, xs):
    """RMSNorm's three readings on the rotation ``xs`` of (x, scale), the
    kernel's and ``F.rms_norm``'s alike: (a) ``cold_ms`` back to back, (b)
    device-only ms and (c) host µs per call (``held_ms``)."""
    from repro_torch.kernels.rmsnorm import rmsnorm as rms

    d = xs[0][0].shape[1]
    lib = lambda t, w: torch.nn.functional.rms_norm(t, (d,), w, 1e-6)
    out = {}
    for who, fn in (("kernel", rms.rmsnorm_2d), ("library", lib)):
        dev_ms, host_us = held_ms(torch, fn, xs)
        out[who] = dict(cold_ms=cold_ms(torch, fn, xs), device_ms=dev_ms,
                        host_us=host_us)
    return out


def rms_rotation(torch, gen, x, sc):
    """x, and more normal inputs of its shape and dtype with the same
    scale, until the launches' inputs and outputs together exceed
    COLD_BYTES (at least two)."""
    k = max(2, math.ceil(COLD_BYTES / (2 * x.numel() * x.element_size())))
    return [(x, sc)] + [(torch.randn(x.shape, device=x.device, generator=gen)
                         .to(x.dtype), sc) for _ in range(k - 1)]


def rms_reading_line(what, r, bound):
    """One printed line of ``rms_readings``' numbers beside the bound."""
    def part(p):
        return (f"cold {p['cold_ms']:.4f} ms, device {p['device_ms']:.4f} "
                f"ms, host {p['host_us']:.1f} µs a call")
    k, lib = r["kernel"], r["library"]
    return (f"  {what}: kernel {part(k)} | F.rms_norm {part(lib)} | bound "
            f"{bound:.4f} ms; device kernel / library "
            f"{k['device_ms'] / lib['device_ms']:.3f}, bound / kernel "
            f"{bound / k['device_ms']:.1%}")


def bound_ms(nbytes, nops, flop_per_s=F32_FLOP_PER_S):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = nops / flop_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_abs(x, y):
    return float((x - y).abs().max()) if x.numel() else 0.0


def bitwise(torch, x, y):
    as_int = torch.int16 if x.element_size() == 2 else torch.int32
    return x.shape == y.shape and x.dtype == y.dtype and torch.equal(
        x.contiguous().view(as_int), y.contiguous().view(as_int))


# ---------------------------------------------------------------------------
# Phase 3: ragged synthetic layouts
# ---------------------------------------------------------------------------

def sass_of(path):
    """The SASS of a built library, by ``cuobjdump -sass`` of the toolkit
    that built it, or of the copy in Triton's package."""
    import subprocess

    from repro_torch.kernels import build
    tools = [os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")]
    try:
        import triton
        tools.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for tool in tools:
        if os.path.exists(tool):
            return subprocess.run([tool, "-sass", str(path)], check=True,
                                  capture_output=True, text=True).stdout
    raise RuntimeError(f"no cuobjdump among {tools}")


def ragged_phase(torch, dev):
    from repro_torch.fastpath import kernels, kernels_ref
    from repro_torch.fastpath.layout import FlatLayout
    from repro_torch.fastpath.plan import FastPathPlan

    tmpl = {f"l{i}": torch.empty((s,), device="meta")
            for i, s in enumerate(RAGGED)}
    lo = FlatLayout.for_tree(tmpl)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def buf(W, scale=1.0):
        flat = lo.empty((W,), dev)
        for v in lo.unflatten_stacked(flat).values():
            if v.numel():
                v.normal_(0.0, scale, generator=gen)
        return flat

    plan = FastPathPlan("on")
    for W in (1, 3):
        a, b, c = buf(W), buf(W), buf(W, 0.1)
        for name, bb in (("stacked", b), ("unstacked", b[0])):
            got = kernels.delta_sqnorm_blocks(a, bb)
            want = kernels_ref.delta_sqnorm_blocks(a, bb)
            torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
            ms = cuda_ms(torch, lambda: kernels.delta_sqnorm_blocks(a, bb),
                         n=20)
            print(f"  ragged W={W} delta_sqnorm_blocks[{name}] max_abs_err "
                  f"{max_abs(got, want):.3e} {ms:.4f} ms")
        got = kernels.sqnorm_blocks(a)
        want = kernels_ref.sqnorm_blocks(a)
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
        ms = cuda_ms(torch, lambda: kernels.sqnorm_blocks(a), n=20)
        print(f"  ragged W={W} sqnorm_blocks max_abs_err "
              f"{max_abs(got, want):.3e} {ms:.4f} ms")
        got = kernels.absmax_blocks(a, b, c)
        check(bitwise(torch, got, kernels_ref.absmax_blocks(a, b, c)),
              f"absmax_blocks W={W} not bitwise")
        ms = cuda_ms(torch, lambda: kernels.absmax_blocks(a, b, c), n=20)
        print(f"  ragged W={W} absmax_blocks bitwise {ms:.4f} ms")
        for bits in (2, 4, 8):
            steps = plan._per_leaf(got, lo, "max") / float(2 ** (bits - 1)
                                                           - 1)
            subs = steps[:, plan.sub_leaf(lo, dev)].contiguous()
            p, r, sq = kernels.laq_encode_blocks(a, b, c, subs, bits)
            wp, wr, wsq = kernels_ref.laq_encode_blocks(a, b, c, subs, bits)
            check(bitwise(torch, p, wp) and bitwise(torch, r, wr),
                  f"laq_encode_blocks W={W} bits={bits} not bitwise")
            torch.testing.assert_close(sq, wsq, rtol=SUM_RTOL, atol=0)
            ms = cuda_ms(torch, lambda: kernels.laq_encode_blocks(
                a, b, c, subs, bits), n=20)
            print(f"  ragged W={W} laq_encode_blocks[bits={bits}] payload/"
                  f"residual bitwise, sq max_abs_err {max_abs(sq, wsq):.3e}"
                  f" {ms:.4f} ms")
        mask = torch.tensor([True, False, True][:W], device=dev)
        for mode in ("add", "update", "select"):
            for name, aa in (("stacked", a), ("unstacked", a[0])):
                got = kernels.masked_combine(aa, b, mask, mode)
                check(bitwise(torch, got, kernels_ref.masked_combine(
                    aa, b, mask, mode)),
                    f"masked_combine {mode} {name} W={W} not bitwise")
                ms = cuda_ms(torch, lambda: kernels.masked_combine(
                    aa, b, mask, mode), n=20)
                print(f"  ragged W={W} masked_combine[{mode},{name}] "
                      f"bitwise {ms:.4f} ms")


# ---------------------------------------------------------------------------
# Phase 4: the main path's shapes
# ---------------------------------------------------------------------------

def chunked(fn, rows, step=1 << 19):
    """Apply a plain version over whole-sub-block row chunks (results
    dropped as they come: only the time is wanted)."""
    for r0 in range(0, rows, step):
        fn(r0, min(r0 + step, rows))


def full_shape_phase(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import param_layout
    from repro_torch.fastpath import kernels, kernels_ref
    from repro_torch.fastpath.plan import FastPathPlan

    lo = param_layout(get_config("llama3.2-1b"))
    W, R = 2, lo.rows
    N, S = W * R * 128, W * R // 8
    print(f"  layout: {lo.num_leaves} leaves, rows {R}, W {W}: {N} elements"
          f" per operand (2^31 = {2 ** 31})")
    check(N > 2 ** 31, "full-shape operand must exceed 2^31 elements")
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    a = torch.randn((W, R, 128), device=dev, generator=gen)
    b = torch.randn((W, R, 128), device=dev, generator=gen)
    c = torch.randn((W, R, 128), device=dev, generator=gen) * 0.1
    results = {}

    def plain_ms(fn):
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        chunked(fn, R)
        e.record()
        e.synchronize()
        return s.elapsed_time(e)

    def sub_rows(r0, r1):
        return slice(r0 // 8, r1 // 8)

    # -- delta_sqnorm_blocks (lag-wk LHS: both operands stacked) ------------
    out = kernels.delta_sqnorm_blocks(a, b)
    err = 0.0
    for r0 in range(0, R, 1 << 19):
        r1 = min(r0 + (1 << 19), R)
        want = kernels_ref.delta_sqnorm_blocks(a[:, r0:r1], b[:, r0:r1])
        got = out[:, sub_rows(r0, r1)]
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
        err = max(err, max_abs(got, want))
    t_b, by = bound_ms(2 * N * 4 + S * 4, 3 * N)
    results["delta_sqnorm_blocks"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: kernels.delta_sqnorm_blocks(a, b)),
        plain_ms=plain_ms(lambda r0, r1: kernels_ref.delta_sqnorm_blocks(
            a[:, r0:r1], b[:, r0:r1])),
        bound_ms=t_b, bound_by=by, library_ms=None)
    del out

    # -- sqnorm_blocks (plan.sqnorm; no path of the reference calls it) -----
    out = kernels.sqnorm_blocks(a)
    err = 0.0
    for r0 in range(0, R, 1 << 19):
        r1 = min(r0 + (1 << 19), R)
        want = kernels_ref.sqnorm_blocks(a[:, r0:r1])
        got = out[:, sub_rows(r0, r1)]
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
        err = max(err, max_abs(got, want))
    t_b, by = bound_ms(N * 4 + S * 4, 2 * N)
    results["sqnorm_blocks"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: kernels.sqnorm_blocks(a)),
        plain_ms=plain_ms(lambda r0, r1: kernels_ref.sqnorm_blocks(
            a[:, r0:r1])),
        bound_ms=t_b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.linalg.vector_norm(
            a.view(W, -1, 1024), dim=2)))
    del out

    # -- absmax_blocks ------------------------------------------------------
    parts = kernels.absmax_blocks(a, b, c)
    for r0 in range(0, R, 1 << 19):
        r1 = min(r0 + (1 << 19), R)
        check(bitwise(torch, parts[:, sub_rows(r0, r1)],
                      kernels_ref.absmax_blocks(a[:, r0:r1], b[:, r0:r1],
                                                c[:, r0:r1])),
              "absmax_blocks at full shape not bitwise")
    t_b, by = bound_ms(3 * N * 4 + S * 4, 4 * N)
    results["absmax_blocks"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: kernels.absmax_blocks(a, b, c)),
        plain_ms=plain_ms(lambda r0, r1: kernels_ref.absmax_blocks(
            a[:, r0:r1], b[:, r0:r1], c[:, r0:r1])),
        bound_ms=t_b, bound_by=by, library_ms=None)

    # -- laq_encode_blocks (bits 4, steps from the per-leaf absmax) ---------
    plan = FastPathPlan("auto")
    steps = plan._per_leaf(parts, lo, "max") / 7.0
    subs = steps[:, plan.sub_leaf(lo, dev)].contiguous()
    p, r, sq = kernels.laq_encode_blocks(a, b, c, subs, 4)
    err = 0.0
    for r0 in range(0, R, 1 << 19):
        r1 = min(r0 + (1 << 19), R)
        wp, wr, wsq = kernels_ref.laq_encode_blocks(
            a[:, r0:r1], b[:, r0:r1], c[:, r0:r1],
            subs[:, sub_rows(r0, r1)], 4)
        check(bitwise(torch, p[:, r0:r1], wp) and bitwise(torch, r[:, r0:r1],
                                                          wr),
              "laq_encode_blocks at full shape not bitwise")
        torch.testing.assert_close(sq[:, sub_rows(r0, r1)], wsq,
                                   rtol=SUM_RTOL, atol=0)
        err = max(err, max_abs(sq[:, sub_rows(r0, r1)], wsq))
        del wp, wr, wsq
    t_b, by = bound_ms(5 * N * 4 + 2 * S * 4, 10 * N)
    results["laq_encode_blocks"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: kernels.laq_encode_blocks(
            a, b, c, subs, 4, payload_out=p), n=3),
        plain_ms=plain_ms(lambda r0, r1: kernels_ref.laq_encode_blocks(
            a[:, r0:r1], b[:, r0:r1], c[:, r0:r1],
            subs[:, sub_rows(r0, r1)], 4)),
        bound_ms=t_b, bound_by=by, library_ms=None)
    del p, r, sq

    # -- masked_combine (add: the ĝ fold; select: θ̂ / residual) -----------
    mask = torch.tensor([True, False], device=dev)
    m3 = mask.to(torch.float32).view(W, 1, 1)
    for mode in ("add", "select"):
        got = kernels.masked_combine(a, b, mask, mode)
        for r0 in range(0, R, 1 << 19):
            r1 = min(r0 + (1 << 19), R)
            check(bitwise(torch, got[:, r0:r1], kernels_ref.masked_combine(
                a[:, r0:r1], b[:, r0:r1], mask, mode)),
                f"masked_combine {mode} at full shape not bitwise")
        del got
    sel_ms = cuda_ms(torch, lambda: kernels.masked_combine(a, b, mask,
                                                           "select"))
    print(f"  masked_combine[select] {sel_ms:.3f} ms (torch.where "
          f"{cuda_ms(torch, lambda: torch.where(m3 != 0, a, b)):.3f} ms)")
    t_b, by = bound_ms(3 * N * 4 + W * 4, 2 * N)
    results["masked_combine"] = dict(
        max_abs_err=0.0,
        ms=cuda_ms(torch, lambda: kernels.masked_combine(a, b, mask, "add")),
        plain_ms=plain_ms(lambda r0, r1: kernels_ref.masked_combine(
            a[:, r0:r1], b[:, r0:r1], mask, "add")),
        bound_ms=t_b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.addcmul(b, a, m3)))
    for k, v in results.items():
        print(f"  full-shape {k}: max_abs_err {v['max_abs_err']:.3e} | "
              f"{v['ms']:.3f} ms (plain {v['plain_ms']:.3f} ms, bound "
              f"{v['bound_ms']:.3f} ms by {v['bound_by']}, library "
              f"{v['library_ms']})")
    del a, b, c, parts
    return results


# ---------------------------------------------------------------------------
# Phase 5: the main path through the entry point
# ---------------------------------------------------------------------------

def scheduled_uploaders(algo, steps, workers=2, seed=0):
    """The worker a schedule spec uploads from at each round (None for a
    triggered policy): cyc- round-robin, num- the policy's own draw."""
    from repro_torch.comm import ScheduledPolicy
    from repro_torch.dist.lag_trainer import TrainerConfig

    pol = TrainerConfig(algo=algo, num_workers=workers).comm_policy()
    if not isinstance(pol, ScheduledPolicy):
        return None
    if pol.needs_rng:
        return [pol.draw(k, workers, seed) for k in range(steps)]
    return [k % workers for k in range(steps)]


def trainer_phase(torch, algo, steps=4, use_pallas_comm=False, extra=(),
                  arch="llama3.2-1b", workers=2, digest_after=None):
    """Run the launcher on ``arch`` at full width (``extra``: more launcher
    flags, e.g. ``--server``); returns the launches of the batched plane's kernels
    (``plane``) and of the legacy per-leaf kernels (``legacy``), the
    rounds' losses and masks, the peak memory and (``digest_after``) the
    bit digests of the state after that many rounds.  Round 0 uploads from
    every worker for a triggered policy; a schedule uploads from exactly
    its scheduled worker every round."""
    from repro_torch.fastpath import kernels
    from repro_torch.kernels.lag_trigger import lag_trigger as lt
    from repro_torch.launch import train

    rounds = []

    def on_step(step, m, timing):
        # a fleet's uploads are its cohort's (its comm_mask is population
        # wide)
        mask = m.get("cohort_comm", m["comm_mask"])
        rounds.append(dict(loss=float(m["loss"]),
                           mask=mask.to(torch.int32).tolist(),
                           cohort=m["cohort_ids"].tolist()
                           if "cohort_ids" in m else None,
                           skipped=int(m["skipped_round"]),
                           comm_total=int(m["comm_total"]), **timing))

    digest, make = {}, train.make_train_step
    if digest_after is not None and digest_after < steps:
        # the state after ``digest_after`` rounds, read by wrapping the
        # launcher's step for this run (phase 23c holds its rounds to
        # phase 5's first ones)
        def make_digesting(*a, **kw):
            step = make(*a, **kw)

            def run(state, batch):
                state, m = step(state, batch)
                if state["step"] == digest_after:
                    digest.update(state_digests(torch, state))
                return state, m
            return run
        train.make_train_step = make_digesting
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    lt.reset_launches()
    try:
        state = train.main(["--arch", arch, "--algo", algo,
                            "--workers", str(workers), "--batch", "4",
                            "--seq", "256",
                            "--steps", str(steps), "--seed", "0", *extra],
                           on_step=on_step, use_pallas_comm=use_pallas_comm)
    finally:
        train.make_train_step = make
    launches = dict(kernels.LAUNCHES)
    legacy = dict(lt.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(len(rounds) == steps, f"{algo}: {len(rounds)} rounds")
    check(all(math.isfinite(r["loss"]) for r in rounds),
          f"{algo}: non-finite loss")
    check(bool(torch.isfinite(state["theta"]).all()),
          f"{algo}: non-finite parameters")
    check(rounds[-1]["comm_total"] == sum(sum(r["mask"]) for r in rounds),
          f"{algo}: comm_total disagrees with the masks")
    if digest_after == steps:
        digest = state_digests(torch, state)
    sched = scheduled_uploaders(algo, steps)
    if sched is None:
        # (under churn a cohort client may have left before round 0)
        check(all(rounds[0]["mask"]) or "--fleet-churn" in extra,
              f"{algo}: round 0 must upload all")
    else:
        for k, (r, m) in enumerate(zip(rounds, sched)):
            check(r["mask"] == [int(i == m) for i in range(workers)],
                  f"{algo} round {k}: mask {r['mask']}, scheduled worker {m}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    steady = rounds[1:]
    summary = {k: sum(r[k] for r in steady) / len(steady)
               for k in ("ms", "grad_ms", "comm_ms", "gather_ms",
                         "scatter_ms", "mix_ms") if k in steady[0]}
    shown = {**launches, **legacy} if use_pallas_comm else launches
    label = " ".join(((arch,) if arch != "llama3.2-1b" else ())
                     + (algo,) + tuple(extra)
                     + (() if workers == 2 else (f"W={workers}",)))
    if "mix_ms" in summary:
        label += f" (mix + history {summary['mix_ms']:.1f} ms a round)"
    fleet = "" if rounds[0]["cohort"] is None else (
        f" | cohorts {[r['cohort'] for r in rounds]} | gather "
        f"{summary['gather_ms']:.1f} ms, scatter {summary['scatter_ms']:.1f}"
        f" ms a round (device)")
    print(f"  {label}: losses {[round(r['loss'], 6) for r in rounds]} | "
          f"masks {[r['mask'] for r in rounds]} | comm_total "
          f"{rounds[-1]['comm_total']} | rounds 1-{steps - 1} mean "
          f"{summary['ms']:.1f} ms (device: fwd/bwd {summary['grad_ms']:.1f}"
          f" ms, comm plane + server {summary['comm_ms']:.1f} ms) | round 0 "
          f"{rounds[0]['ms']:.1f} ms | peak memory {peak:.2f} GB | launches "
          f"{shown}" + fleet + ("" if sched is None else
                                f" | scheduled uploaders {sched}"))
    return dict(plane=launches, legacy=legacy, rounds=rounds, peak=peak,
                summary=summary, digest=digest or None)


# ---------------------------------------------------------------------------
# Phase 6: GPU (kernels) vs CPU (plain versions) on a small input
# ---------------------------------------------------------------------------

def small_agreement_phase(torch, dev):
    from repro_torch.fastpath import kernels
    from repro_torch.fastpath.plan import FastPathPlan

    # the plane's LAQ steps on the card, each beside the scales it divided
    steps_seen = []
    encode = FastPathPlan.laq_encode

    def recording_encode(self, g, q, e, lo, *, bits, payload_out=None):
        # the scales first: the payload may overwrite g
        scales = self._per_leaf(kernels.absmax_blocks(g, q, e), lo, "max")
        out = encode(self, g, q, e, lo, bits=bits, payload_out=payload_out)
        if g.is_cuda:
            steps_seen.append((scales, out[3], bits))
        return out

    FastPathPlan.laq_encode = recording_encode
    try:
        agreement_runs(torch, dev)
    finally:
        FastPathPlan.laq_encode = encode
    check(steps_seen, "laq@4 on the plane made no encode on the card")
    n_steps = n_recip = 0
    for scales, steps, bits in steps_seen:
        qmax = float(2 ** (bits - 1) - 1)
        check(bitwise(torch, steps.cpu(), scales.cpu() / torch.tensor(qmax)),
              "the plane's LAQ steps on the card differ from the IEEE "
              "division of their scales")
        live = torch.isfinite(scales)
        n_steps += int(live.sum())
        # what torch's reciprocal multiply (a Python-scalar divisor) gives
        n_recip += int(((scales / qmax) != steps)[live].sum())
    print(f"  plane laq@4 on the card: {n_steps} steps in {len(steps_seen)} "
          f"encodes equal the CPU's IEEE division of their scales bit for "
          f"bit ({n_recip} of them differ from scale / {qmax} computed with "
          f"a Python-scalar divisor on the card)")


def agreement_runs(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                              make_train_step, params_of)

    cfg = get_config("llama3.2-1b").reduced()
    for algo, legacy, lr in AGREEMENT_RUNS:
        tcfg = TrainerConfig(algo=algo, num_workers=2, lr=lr,
                             use_pallas_comm=legacy)
        cpu = init_state(cfg, tcfg, device="cpu", seed=5)
        gpu = init_state(cfg, tcfg, device=dev,
                         params=params_of(cpu, cfg))
        # auto on CPU tensors is the per-leaf oracle: force the plane so
        # the CPU side runs the kernels' plain versions (the legacy route
        # runs its plain versions on CPU tensors by itself)
        cpu_step = make_train_step(cfg, tcfg if legacy
                                   else tcfg.replace(fastpath="on"))
        gpu_step = make_train_step(cfg, tcfg)
        stream = TokenStream(cfg.vocab_size, seed=5)
        masks = []
        for k in range(3):
            b = make_inputs(cfg, stream, k, 4, 32, device="cpu")
            cpu, mc = cpu_step(cpu, b)
            gpu, mg = gpu_step(gpu, {n: t.to(dev) for n, t in b.items()})
            lc, lg = float(mc["loss"]), float(mg["loss"])
            check(abs(lc - lg) <= 1e-4 * abs(lc),
                  f"small {algo} legacy={legacy} round {k}: loss cpu {lc} "
                  f"vs gpu {lg}")
            check(mc["comm_mask"].tolist() == mg["comm_mask"].cpu().tolist(),
                  f"small {algo} legacy={legacy} round {k}: masks differ")
            masks.append(mg["comm_mask"].to(torch.int32).tolist())
        route = "legacy per-leaf route" if legacy else "batched plane"
        print(f"  small {algo} lr {lr} ({route}): 3 rounds, GPU vs CPU "
              f"losses within rtol 1e-4, masks equal (last loss {lg:.6f}, "
              f"masks {masks})")


# ---------------------------------------------------------------------------
# Phase 7: the model kernels vs their plain versions
# ---------------------------------------------------------------------------

def model_kernel_phase(torch, dev):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rms

    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    errs = []

    def compare(what, got, want):
        err = max_abs(got, want)
        ok = bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, rtol=MODEL_TOL, atol=MODEL_TOL)
        errs.append((what, err, ok))
        return err

    for rows in (1, 7, 129, 1000):
        for d in (2048, 256, 132):
            x = torch.randn((rows, d), device=dev, generator=gen)
            sc = torch.randn((d,), device=dev, generator=gen)
            compare(f"rmsnorm ({rows}, {d})", rms.rmsnorm_2d(x, sc),
                    rms_ref.rmsnorm(x, sc))
    cases = [(S, S, c, w) for S in FLASH_S for c, w in FLASH_MASKS]
    cases += FLASH_CROSS
    for S, Skv, causal, window in cases:
        q = torch.randn((1, S, 32, 64), device=dev, generator=gen)
        k = torch.randn((1, Skv, 8, 64), device=dev, generator=gen)
        v = torch.randn((1, Skv, 8, 64), device=dev, generator=gen)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = fa_ref.attention(q, k, v, causal=causal, window=window)
        if S > Skv and window is not None:       # rows that see no key
            live = torch.arange(S, device=dev) - window + 1 < Skv
            got, want = got[:, live], want[:, live]
        compare(f"flash_attention Sq {S} Skv {Skv} causal {causal} "
                f"window {window}", got, want)
    for what, err, ok in errs:
        print(f"  {what}: max_abs_err {err:.3e}{'' if ok else '  FAILED'}")

    results = {}
    # -- rmsnorm at prefill: (B·S, d) = (8192, 2048) ------------------------
    R, d = RMS_FULL
    x = torch.randn((R, d), device=dev, generator=gen)
    sc = torch.randn((d,), device=dev, generator=gen)
    err = compare("rmsnorm full", rms.rmsnorm_2d(x, sc),
                  rms_ref.rmsnorm(x, sc))
    t_b, by = bound_ms(2 * R * d * 4 + d * 4, 4 * R * d)
    rd = rms_readings(torch, rms_rotation(torch, gen, x, sc))
    print(rms_reading_line(f"rmsnorm ({R}, {d})", rd, t_b))
    results["rmsnorm"] = dict(
        max_abs_err=err, ms=rd["kernel"]["device_ms"],
        plain_ms=cuda_ms(torch, lambda: rms_ref.rmsnorm(x, sc), n=20),
        bound_ms=t_b, bound_by=by, library_ms=rd["library"]["device_ms"])
    del x, sc

    # -- flash attention at prefill: (4, 2048, 32/8, 64), causal -------------
    B, S, H, KV, hd = ATTN_FULL
    q = torch.randn((B, S, H, hd), device=dev, generator=gen)
    k = torch.randn((B, S, KV, hd), device=dev, generator=gen)
    v = torch.randn((B, S, KV, hd), device=dev, generator=gen)
    err = compare("flash_attention full", fa.flash_attention_fwd(q, k, v),
                  fa_ref.attention(q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # the two products the causal mask leaves; the kernel runs each as
    # three TF32 products on the tensor cores
    nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    flop = 4 * B * H * hd * S * (S + 1) // 2
    t_b, by = bound_ms(nbytes, 3 * flop, TF32_FLOP_PER_S)
    r = results["flash_attention"] = dict(
        max_abs_err=err,
        ms=cuda_ms(torch, lambda: fa.flash_attention_fwd(q, k, v), n=10),
        plain_ms=cuda_ms(torch, lambda: fa_ref.attention(q, k, v), n=3),
        bound_ms=t_b, bound_by=by,
        fma_bound_ms=bound_ms(nbytes, flop)[0],
        library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), n=10))
    r["library_ratio"] = r["ms"] / r["library_ms"]
    del q, k, v, qt, kt, vt
    for k_, r in results.items():
        print(f"  full-shape {k_}: max_abs_err {r['max_abs_err']:.3e} | "
              f"{r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}, library "
              f"{r['library_ms']:.4f} ms)")
    r = results["flash_attention"]
    print(f"  flash_attention: bound {r['bound_ms']:.4f} ms as split TF32 "
          f"(3 x {flop / 1e9:.1f} GFLOP at {TF32_FLOP_PER_S / 1e12:.0f} "
          f"TFLOP/s), {r['fma_bound_ms']:.4f} ms on the FMA units "
          f"({F32_FLOP_PER_S / 1e12:.0f} TFLOP/s) | kernel "
          f"{r['ms']:.4f} ms = {r['bound_ms'] / r['ms']:.1%} of its bound | "
          f"kernel / library {r['library_ratio']:.3f}")
    bad = [what for what, _, ok in errs if not ok]
    check(not bad, f"kernel vs plain beyond rtol = atol = {MODEL_TOL}: "
                   f"{bad}")
    return results


# ---------------------------------------------------------------------------
# Phase 8: the serving path through the entry point
# ---------------------------------------------------------------------------

def prefill_launches(cfg):
    """The kernels' launches per prefill: RMSNorm before every mixer and
    every MLP or MoE FFN (an ssd layer has neither) and the final norm;
    flash attention once per attention layer (dense, lattn, moe)."""
    pat = cfg.block_pattern
    kinds = [pat[i % len(pat)] for i in range(cfg.num_layers)]
    return {"rmsnorm": sum(1 if k == "ssd" else 2 for k in kinds) + 1,
            "flash_attention": sum(k in ("dense", "lattn", "moe")
                                   for k in kinds)}


def named_leaves(tree, name=""):
    """[(the leaf's dict key, tensor)] in JAX's leaf order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in named_leaves(tree[k], k)]
    if isinstance(tree, (list, tuple)):
        return [x for c in tree for x in named_leaves(c, name)]
    return [(name, tree)]


class MoeRouting:
    """17b: an MoE prefill's kernel route against its plain route.  A
    routing decision is discrete: a last-bit difference of a router input
    that sits on a top-K boundary sends a token to another expert, and its
    hidden state and every cache entry after it then part by O(1), so the
    two routes' values cannot be compared as they run free.  So the kernel
    route's decisions are recorded layer by layer (``recorded``) and
    imposed on the plain route (``imposed``: the plain route's own
    probabilities, gated at the kernel route's experts and slots), whose
    values are then held to the kernel route's within SERVE_TOL as phase 8
    holds them.  Its own decisions on the same inputs are counted: each
    one that differs must sit on a near-tie that the two routes'
    probability difference δ explains (the plain route's gap between the
    two experts ≤ 2δ)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe.route
        self.kernel, self.rows = [], []

    @contextlib.contextmanager
    def _patched(self, fn):
        self.moe.route = fn
        try:
            yield
        finally:
            self.moe.route = self.route

    def recorded(self):
        def route(p, xg, cfg):
            self.kernel.append(self.route(p, xg, cfg))
            return self.kernel[-1]
        return self._patched(route)

    def imposed(self):
        import torch
        layers = iter(self.kernel)

        def route(p, xg, cfg):
            want, own = next(layers), self.route(p, xg, cfg)
            self.rows.append(self._flips(torch, want, own))
            gates = own.probs.gather(-1, want.experts)
            gates = gates / torch.sum(gates, -1, keepdim=True)
            return own._replace(gates=gates, experts=want.experts,
                                slots=want.slots, kept=want.kept)
        return self._patched(route)

    @staticmethod
    def _flips(torch, want, own):
        """(tokens whose top-K set differs, whose top-1 differs, δ, the
        largest gap of the plain route's probabilities across a flip)."""
        p = own.probs
        delta = float((p - want.probs).abs().max())

        def members(r):
            return torch.zeros_like(p, dtype=torch.bool).scatter_(
                -1, r.experts, True)

        mk, mo = members(want), members(own)
        inf = torch.tensor(float("inf"), device=p.device)
        set_gap = (torch.where(mo & ~mk, p, -inf).amax(-1)
                   - torch.where(mk & ~mo, p, inf).amin(-1))
        set_flip = (mk != mo).any(-1)
        t1k, t1o = want.experts[..., :1], own.experts[..., :1]
        top_flip = (t1k != t1o)[..., 0]
        top_gap = (p.gather(-1, t1o) - p.gather(-1, t1k))[..., 0]
        gaps = torch.cat([set_gap[set_flip], top_gap[top_flip]])
        return (int(set_flip.sum()), int(top_flip.sum()), delta,
                float(gaps.max()) if gaps.numel() else 0.0)

    def report(self, torch, arch):
        check(len(self.rows) == len(self.kernel),
              f"{arch}: {len(self.rows)} imposed of {len(self.kernel)} "
              f"recorded routings")
        tokens = self.kernel[0].experts.shape[0] * \
            self.kernel[0].experts.shape[1]
        sets = [r[0] for r in self.rows]
        tops = [r[1] for r in self.rows]
        worst = max(r[3] / (2 * r[2]) if r[2] else (0.0 if r[3] == 0 else
                                                       math.inf)
                    for r in self.rows)
        print(f"  routing: the plain route's own top-K differs from the "
              f"kernel route's at {sum(sets)} of {tokens * len(self.rows)} "
              f"(token, layer) pairs ({sets} a layer), its top-1 at "
              f"{sum(tops)}; δ a layer {max(r[2] for r in self.rows):.2e} "
              f"at most; the widest flip's gap is {worst:.3f} of its 2δ")
        check(worst <= 1.0, f"{arch}: a routing flip's gap exceeds twice "
                            f"the routes' probability difference: {self.rows}")


def serve_phase(torch, dev, argv=SERVE_ARGS, cfg=None, params=None,
                f32_logits=None):
    """``repro_torch.launch.serve`` with ``argv`` (``cfg``: a config that
    replaces the one ``--arch`` names, e.g. its depth cut), random weights
    from the seed (or ``params``): the kernels' launches per prefill and per
    decode step, the generated tokens, the peak memory, and the prefill
    through the kernels against the plain route on the card.  A bfloat16
    config counts the bfloat16 instantiations (and none of the float32
    ones), holds the two routes within its arch's bounds
    (BF16_ROUTE_FACTOR × BF16_ROUTE_READINGS), the plain route's greedy
    tokens (teacher-forced on the kernel route's) equal to the kernel
    route's where the plain top-2
    margin exceeds BF16_MARGIN × the routes' difference of the prefill
    logits, and, given ``f32_logits``
    (the float32 model's on the same prompts and widened weights), the
    kernel route's error against them within BF16_ERR_RATIO × the plain
    route's.  Returns the launches and round 1's times with the peak."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.rmsnorm import rmsnorm as rms
    from repro_torch.launch import serve
    from repro_torch.models import model

    args = serve.build_argparser().parse_args(argv)
    if cfg is None:
        cfg = get_config(args.arch)
        cfg = cfg.reduced() if args.reduced else cfg
    cfg = cfg.replace(use_pallas=True)
    bf16 = cfg.compute_dtype in (torch.bfloat16, torch.float16)   # 2-byte
    sfx = {torch.bfloat16: "_bf16", torch.float16: "_f16"}.get(
        cfg.compute_dtype, "")
    gc.collect()
    torch.cuda.empty_cache()
    if params is None:
        params = model.init(cfg, device=dev, seed=args.seed)
    rounds = []
    torch.cuda.reset_peak_memory_stats()
    rms.reset_launches()
    fa.reset_launches()
    serve.main(argv, params=params, cfg=cfg,
               on_round=lambda r, t, toks: rounds.append((t, toks)))
    every = {**rms.LAUNCHES, **fa.LAUNCHES}
    peak = torch.cuda.max_memory_allocated() / 1e9
    n = len(rounds)
    check(n == args.rounds, f"serve {cfg.arch_id}: {n} rounds")
    # the instantiations of the config's dtype, and none of the other's
    per_prefill = {k_ + sfx: v for k_, v in prefill_launches(cfg).items()}
    for k_, got in every.items():
        want = per_prefill.get(k_, 0)
        check(got == n * want,
              f"serve {cfg.arch_id}: {k_} launched {got} times in {n} "
              f"rounds, want {want} per prefill and none per decode step")
    launches = {k_: every[k_] for k_ in per_prefill}
    for _, toks in rounds:
        check(tuple(toks.shape) == (args.batch, args.gen),
              f"serve {cfg.arch_id}: tokens {tuple(toks.shape)}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
              f"serve {cfg.arch_id}: token out of the vocabulary")
    check(peak < 80.0, f"serve {cfg.arch_id}: peak memory {peak:.2f} GB")
    timing = rounds[-1][0]
    print(f"  serve {cfg.arch_id} ({cfg.num_layers} layers) round {n - 1}: "
          f"prefill {timing['prefill_ms']:.1f} ms | decode "
          f"{timing['decode_ms']:.1f} ms for {args.gen - 1} tokens "
          f"({timing['ms_per_token']:.2f} ms/token) | round 0 prefill "
          f"{rounds[0][0]['prefill_ms']:.1f} ms | peak memory {peak:.2f} GB"
          f" | launches {launches}")

    # the kernel route against the plain route on the card, same prompts
    prompts = torch.from_numpy(serve.make_prompts(
        cfg.vocab_size, args.batch, args.prompt_len, args.seed + 1)).to(dev)
    outs = {}
    routing = MoeRouting() if "moe" in cfg.block_pattern else None
    with torch.inference_mode():
        for up in (True, False):
            with (routing.recorded() if up else routing.imposed()) \
                    if routing else contextlib.nullcontext():
                last, cache = model.prefill(
                    params, cfg.replace(use_pallas=up), {"tokens": prompts},
                    max_len=args.prompt_len + args.gen)
            outs[up] = (last, named_leaves(cache))
            if bf16 and not up:
                plain_cache = cache
            del cache
    if routing:
        routing.report(torch, cfg.arch_id)
    (lk, ck), (lp, cp) = outs[True], outs[False]
    check(bool(torch.isfinite(lk).all()), "serve: non-finite logits")
    errs = {"logits": max_abs(lk.float(), lp.float())}
    for (name, a), (_, b) in zip(ck, cp):
        key = f"{name} cache"
        errs[key] = max(errs.get(key, 0.0), max_abs(a.float(), b.float()))
    readings = (F16_ROUTE_READINGS if sfx == "_f16"
                else BF16_ROUTE_READINGS)
    bounds = ({k_: BF16_ROUTE_FACTOR * v for k_, v in
               readings[cfg.arch_id].items()} if bf16 else
              dict.fromkeys(errs, SERVE_TOL))
    check(set(bounds) == set(errs), f"serve {cfg.arch_id}: bounds for "
                                    f"{sorted(bounds)}, errors {sorted(errs)}")
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"  prefill kernels vs plain route: max_abs_err "
          f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } | argmax "
          f"agreement {agree:.2f} | logits max |x| "
          f"{float(lp.float().abs().max()):.3f}"
          + (f" | bounds ({BF16_ROUTE_FACTOR} x the arch's readings) "
             f"{ {k: float(f'{v:.3e}') for k, v in bounds.items()} }"
             if bf16 else ""))
    for what, e in errs.items():
        check(e <= bounds[what], f"serve {cfg.arch_id}: {what} differs by "
                                 f"{e} > {bounds[what]}")
    if bf16:
        bf16_greedy(torch, params, cfg, plain_cache, lp, rounds[0][1], args,
                    BF16_MARGIN * errs["logits"])
        del plain_cache
    if f32_logits is not None:
        e_k = max_abs(lk.float(), f32_logits)
        e_p = max_abs(lp.float(), f32_logits)
        print(f"  {cfg.dtype} against float32 logits (same weights, widened): "
              f"kernel route {e_k:.3e}, plain route {e_p:.3e} (ratio "
              f"{e_k / e_p:.3f}; logits max |x| "
              f"{float(f32_logits.abs().max()):.3f})")
        check(e_k <= BF16_ERR_RATIO * e_p,
              f"serve {cfg.arch_id}: the kernel route's {cfg.dtype} error "
              f"{e_k} exceeds {BF16_ERR_RATIO} x the plain route's {e_p}")
    del params, outs, lk, lp, ck, cp
    gc.collect()
    torch.cuda.empty_cache()
    return launches, dict(timing, round0_prefill_ms=rounds[0][0][
        "prefill_ms"], peak_gb=peak)


# ---------------------------------------------------------------------------
# Phase 9: the legacy per-leaf kernels vs their plain versions
# ---------------------------------------------------------------------------

def legacy_kernel_phase(torch, dev):
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist.lag_trainer import param_layout
    from repro_torch.kernels.lag_trigger import lag_trigger as lt
    from repro_torch.kernels.lag_trigger import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(13)

    def rand(n, dtype=torch.float32, scale=1.0, offset=0):
        """n values on the card; ``offset`` 1 starts the view one element
        into its storage (an unaligned base: the scalar path)."""
        x = torch.randn((n + offset,), device=dev, generator=gen) * scale
        return x.to(dtype)[offset:]

    def laq_check(g, q, e, bits, what):
        scale = lt.innovation_absmax_2d(g, q, e)
        check(bitwise(torch, scale, ref.innovation_absmax(g, q, e)),
              f"innovation_absmax_2d {what} not bitwise")
        p, r, sq = lt.laq_encode_2d(g, q, e, scale, bits)
        wp, wr, wsq = ref.laq_encode(g, q, e, scale, bits)
        check(bitwise(torch, p, wp) and bitwise(torch, r, wr),
              f"laq_encode_2d {what} bits={bits} not bitwise")
        torch.testing.assert_close(sq, wsq, rtol=SUM_RTOL, atol=0)
        steps = ops.laq_encode(g, q, e, bits=bits, return_steps=True)[3]
        check(bitwise(torch, steps, ref.quantizer_step(scale, bits)
                      .reshape(1)), f"LAQ steps {what} not bitwise")
        return max_abs(sq, wsq)

    # -- ragged sizes ------------------------------------------------------
    for n in LEGACY_SIZES:
        for offset in (0, 1):
            for dt in (torch.float32, torch.bfloat16):
                a, b = rand(n, dt, offset=offset), rand(n, dt, offset=offset)
                what = f"n={n} offset={offset} {dt}"
                torch.testing.assert_close(lt.sqnorm_2d(a), ref.sqnorm(a),
                                           rtol=SUM_RTOL, atol=0)
                torch.testing.assert_close(lt.delta_sqnorm_2d(a, b),
                                           ref.delta_sqnorm(a, b),
                                           rtol=SUM_RTOL, atol=0)
                for m in (0.0, 1.0):
                    mt = torch.tensor(m, device=dev)
                    check(bitwise(torch, lt.masked_update_2d(a, b, mt),
                                  ref.masked_lazy_update(a, b, mt)),
                          f"masked_update_2d {what} m={m} not bitwise")
            g, q, e = (rand(n, scale=sc, offset=offset)
                       for sc in (1.0, 0.25, 0.01))
            for bits in (2, 4, 8):
                laq_check(g, q, e, bits, f"n={n} offset={offset}")
    print(f"  ragged sizes {LEGACY_SIZES}, aligned and one element off: "
          f"sums within rtol {SUM_RTOL} (float32, bfloat16), masked update "
          f"(m 0/1, float32, bfloat16), absmax, LAQ payload/residual/steps "
          f"(bits 2/4/8) bitwise")
    x = torch.rand((1 << 20,), device=dev, generator=gen) * 10.0
    share = float((x / 7.0 != x / torch.full_like(x, 7.0)).float().mean())
    print(f"  torch on CUDA: x / 7.0 (a Python scalar) differs from the IEEE "
          f"division x / tensor(7.0) in {100 * share:.2f} % of {x.numel()} "
          f"values")
    del x

    # -- every full-width leaf, W = 2 ----------------------------------------
    lo = param_layout(get_config("llama3.2-1b"))
    W = 2
    bufs = [torch.randn((W, lo.rows, 128), device=dev, generator=gen) * sc
            for sc in (1.0, 1.0, 0.1)]
    A, B, C = (tree_leaves(lo.unflatten_stacked(x)) for x in bufs)
    pairs = [(i, m) for m in range(W) for i in range(lo.num_leaves)]
    n_el = W * sum(lo.sizes)
    mask = torch.tensor(1.0, device=dev)
    errs = {"sqnorm_2d": 0.0, "delta_sqnorm_2d": 0.0, "laq_encode_2d": 0.0}

    def check_leaf(a, b, c):
        got, want = lt.sqnorm_2d(a), ref.sqnorm(a)
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
        errs["sqnorm_2d"] = max(errs["sqnorm_2d"], max_abs(got, want))
        got, want = lt.delta_sqnorm_2d(a, b), ref.delta_sqnorm(a, b)
        torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
        errs["delta_sqnorm_2d"] = max(errs["delta_sqnorm_2d"],
                                      max_abs(got, want))
        check(bitwise(torch, lt.masked_update_2d(a, b, mask),
                      ref.masked_lazy_update(a, b, mask)),
              f"masked_update_2d leaf {tuple(a.shape)} not bitwise")
        errs["laq_encode_2d"] = max(errs["laq_encode_2d"], laq_check(
            a, b, c, 4, f"leaf {tuple(a.shape)}"))

    for i in range(lo.num_leaves):
        check_leaf(A[i][0], B[i][0], C[i][0])
    print(f"  {lo.num_leaves} full-width leaves {sorted(lo.sizes)}: all "
          f"match (sum max_abs_err {errs})")

    def each(fn):
        """One round's launches: every leaf of every worker, in turn."""
        def go():
            for i, m in pairs:
                fn(i, m)
        return go

    kern = {
        "sqnorm_2d": lambda i, m: lt.sqnorm_2d(A[i][m]),
        "delta_sqnorm_2d": lambda i, m: lt.delta_sqnorm_2d(A[i][m], B[i][m]),
        "masked_update_2d": lambda i, m: lt.masked_update_2d(
            A[i][m], B[i][m], mask),
        "innovation_absmax_2d": lambda i, m: lt.innovation_absmax_2d(
            A[i][m], B[i][m], C[i][m]),
        "laq_encode_2d": lambda i, m: lt.laq_encode_2d(
            A[i][m], B[i][m], C[i][m], mask, 4),
    }
    plain = {
        "sqnorm_2d": lambda i, m: ref.sqnorm(A[i][m]),
        "delta_sqnorm_2d": lambda i, m: ref.delta_sqnorm(A[i][m], B[i][m]),
        "masked_update_2d": lambda i, m: ref.masked_lazy_update(
            A[i][m], B[i][m], mask),
        "innovation_absmax_2d": lambda i, m: ref.innovation_absmax(
            A[i][m], B[i][m], C[i][m]),
        "laq_encode_2d": lambda i, m: ref.laq_encode(
            A[i][m], B[i][m], C[i][m], mask, 4),
    }
    library = {          # one PyTorch call computing the same function
        "sqnorm_2d": lambda i, m: torch.dot(A[i][m].view(-1),
                                            A[i][m].view(-1)),
        "delta_sqnorm_2d": lambda i, m: torch.dist(A[i][m], B[i][m]),
        "masked_update_2d": lambda i, m: torch.lerp(B[i][m], A[i][m], mask),
    }
    # bytes: each input read once, each output written once; operations
    # per element: sq 2, delta 3, update 3, absmax 4, encode ~10
    work = {"sqnorm_2d": (4 * n_el, 2 * n_el),
            "delta_sqnorm_2d": (8 * n_el, 3 * n_el),
            "masked_update_2d": (12 * n_el, 3 * n_el),
            "innovation_absmax_2d": (12 * n_el, 4 * n_el),
            "laq_encode_2d": (20 * n_el, 10 * n_el)}
    small = min(range(lo.num_leaves), key=lambda i: lo.sizes[i])
    big = max(range(lo.num_leaves), key=lambda i: lo.sizes[i])
    results = {}
    for k, fn in kern.items():
        nbytes, nops = work[k]
        t_b, by = bound_ms(nbytes + len(pairs) * 4, nops)
        lib = library.get(k)
        results[k] = dict(
            max_abs_err=errs.get(k, 0.0), ms=cuda_ms(torch, each(fn), n=3),
            plain_ms=cuda_ms(torch, each(plain[k]), n=2),
            bound_ms=t_b, bound_by=by,
            library_ms=None if lib is None else cuda_ms(torch, each(lib),
                                                        n=3))
        per = {j: cuda_ms(torch, lambda: fn(j, 0), n=20 if j == small else 3)
               for j in (small, big)}
        r = results[k]
        print(f"  round ({len(pairs)} launches) {k}: {r['ms']:.3f} ms (plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by "
              f"{r['bound_by']}, library {r['library_ms']}) | leaf "
              f"{lo.shapes[big]}: {per[big]:.3f} ms, bound "
              f"{bound_ms(nbytes / n_el * lo.sizes[big], 0)[0]:.3f} ms | "
              f"leaf {lo.shapes[small]} (launch-bound): {per[small]:.4f} ms")
    del A, B, C, bufs          # the leaf views hold the 29.7 GB of operands
    gc.collect()
    torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# Phase 10: the legacy per-leaf route through the entry point
# ---------------------------------------------------------------------------

def legacy_route_phase(torch, phase5, steps=4):
    """lag-wk, lag-ps and laq@4 with ``use_pallas_comm=True``; returns the
    legacy kernels' launches over the three runs."""
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import param_layout
    from repro_torch.kernels.lag_trigger import lag_trigger as lt

    per_leaf = 2 * param_layout(get_config("llama3.2-1b")).num_leaves
    per_round = {"lag-wk": ("sqnorm_2d",), "lag-ps": ("sqnorm_2d",),
                 "laq@4": ("innovation_absmax_2d", "laq_encode_2d")}
    totals = {k: 0 for k in lt.LAUNCHES}
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  allocated before the runs: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    for algo, names in per_round.items():
        run = trainer_phase(torch, algo, steps=steps, use_pallas_comm=True)
        check(not any(run["plane"].values()),
              f"{algo}: the batched plane launched {run['plane']} on the "
              f"legacy route")
        for k, v in run["legacy"].items():
            want = per_leaf * steps if k in names else 0
            check(v == want, f"{algo}: {k} launched {v} times in {steps} "
                             f"rounds, want {want}")
            totals[k] += v
        check(run["peak"] < 80.0, f"{algo}: peak memory {run['peak']:.2f} "
                                  f"GB on the legacy route")
        if algo in phase5:
            for k, (r, p) in enumerate(zip(run["rounds"], phase5[algo])):
                check(r["mask"] == p["mask"], f"{algo} round {k}: legacy "
                      f"masks {r['mask']} vs plane {p['mask']}")
                check(abs(r["loss"] - p["loss"]) <= 1e-4 * abs(p["loss"]),
                      f"{algo} round {k}: legacy loss {r['loss']} vs plane "
                      f"{p['loss']}")
            print(f"  {algo}: masks equal to phase 5's, losses within rtol "
                  f"1e-4")
    return totals


# ---------------------------------------------------------------------------
# Phase 11: LASG-WK, the schedules and the server steps through the entry
# point
# ---------------------------------------------------------------------------

def policies_phase(torch, steps=4):
    """PHASE11's runs; returns the launches of the plane's and of the legacy
    route's kernels over all of them."""
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import param_layout

    per_leaf = 2 * param_layout(get_config("llama3.2-1b")).num_leaves
    plane, legacy = {}, {}
    for algo, use_legacy, extra, want in PHASE11:
        run = trainer_phase(torch, algo, steps=steps,
                            use_pallas_comm=use_legacy, extra=extra)
        label = " ".join((algo,) + tuple(extra)) + (
            " (legacy route)" if use_legacy else "")
        got = run["plane"]
        for k, v in got.items():
            if k in want:
                check(v >= want[k] * steps, f"{label}: {k} launched {v} "
                      f"times in {steps} rounds, want >= {want[k]} a round")
            elif not want:
                check(v == 0, f"{label}: the plane's {k} launched {v} times")
            plane[k] = plane.get(k, 0) + v
        for k, v in run["legacy"].items():
            n = per_leaf * steps if use_legacy and k == "sqnorm_2d" else 0
            check(v == n, f"{label}: {k} launched {v} times in {steps} "
                          f"rounds, want {n}")
            legacy[k] = legacy.get(k, 0) + v
        check(run["peak"] < 80.0, f"{label}: peak memory "
                                  f"{run['peak']:.2f} GB")
    return plane, legacy


# ---------------------------------------------------------------------------
# Phase 12: the convex simulation
# ---------------------------------------------------------------------------

def timed_run(torch, run):
    """(report, ms per round): host clock around a run that ends in a
    device synchronise, divided by its rounds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = run()
    torch.cuda.synchronize()
    return rep, (time.perf_counter() - t0) * 1e3 / len(rep.losses)


def traced_rounds(torch, run):
    """(device kernels a round, their busy ms a round, the device's idle
    share) over ``run()``'s rounds, from a ``torch.profiler`` trace (the
    profiler's own host cost included in the wall time)."""
    from repro_torch.launch.profile_comm import _kernel_times

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rep = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, by_name = _kernel_times(prof)
    K = len(rep.losses)
    n = sum(c for _, c in by_name.values())
    idle = f"{100 * (1 - busy / wall_ms):.1f} %" if n else "not measured"
    return n / K, busy / K, idle


def on_cpu(problem, device="cpu"):
    """The same problem (bitwise the same tensors) on the CPU, or on
    ``device``."""
    from repro_torch.core.convex import Problem
    return Problem(name=problem.name, kind=problem.kind,
                   X=problem.X.to(device), y=problem.y.to(device),
                   L_m=problem.L_m.to(device), L=problem.L, lam=problem.lam)


# a CPU-only child's program: ``body`` binds ``result`` (and may restart
# the clock ``t0``); (result, its seconds) go back pickled on stdout, and
# everything the body prints goes to stderr
CHILD_MAIN = """
import pickle, sys, time
out, sys.stdout = sys.stdout.buffer, sys.stderr
import torch
torch.set_num_threads({threads})
t0 = time.perf_counter()
{body}
pickle.dump((result, time.perf_counter() - t0), out)
out.flush()
"""
GISETTE_CHILD = f"""
from repro_torch.core import convex
result = convex.gisette_standin(**{GISETTE!r}, dtype=torch.float64,
                                device="cpu")
"""
FLEET_CHILD = """
from repro_torch.engine import Experiment
from repro_torch.fleet import fleet_problem
N, k, K = {FLEET_SCALE!r}
cpu = fleet_problem("linreg", num_clients=N, n_per=2, d=4,
                    dtype=torch.float32, device="cpu")
_, opt = cpu.optimum()
t0 = time.perf_counter()
result = (Experiment(problem=cpu, fastpath="on", algo="lag-wk", steps=K,
                     opt_loss=opt, topology=f"fleet:{{N}}@{{k}}",
                     cluster=f"fleet:{{N}}@50ms/20Mbps").run(), opt)
""".format(FLEET_SCALE=FLEET_SCALE)
CHILDREN = []


class cpu_child:
    """Runs ``body`` (see CHILD_MAIN) in a Python process of its own that
    sees no card, with CPU_CHILD_THREADS threads, from the start;
    ``result()`` waits for it and returns (result, seconds).  The process
    is stopped by ``stop_children`` if it is still running at the end."""

    def __init__(self, body):
        import subprocess
        threads = str(CPU_CHILD_THREADS)
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS=
                   threads, OPENBLAS_NUM_THREADS=threads, MKL_NUM_THREADS=
                   threads, PYTHONPATH=SRC + (os.pathsep + path if path
                                              else ""))
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             CHILD_MAIN.format(threads=threads, body=body)],
            env=env, cwd=HERE, stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE)
        CHILDREN.append(self.proc)

    def result(self):
        import pickle
        out, _ = self.proc.communicate()
        check(self.proc.returncode == 0,
              f"a CPU-only child exited with {self.proc.returncode}")
        return pickle.loads(out)


def stop_children():
    for proc in CHILDREN:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def to_eps(rep, eps):
    return rep.iters_to(eps), rep.comms_to(eps), rep.bytes_to(eps)


def masks_through(got, want, eps):
    """Rounds 0..iters_to(eps) of ``want`` (all when it never gets there);
    True iff ``got``'s masks equal ``want``'s there."""
    k = want.iters_to(eps)
    n = len(want.losses) if k is None else k + 1
    return n, bool((got.comm_mask[:n] == want.comm_mask[:n]).all())


def reset_counts():
    from repro_torch.fastpath import kernels
    from repro_torch.kernels.lag_trigger import lag_trigger as lt
    kernels.reset_launches()
    lt.reset_launches()


def counts():
    from repro_torch.fastpath import kernels
    from repro_torch.kernels.lag_trigger import lag_trigger as lt
    return {**kernels.LAUNCHES, **lt.LAUNCHES}


def convex_fig3_float64(torch, dev):
    """12a: every ALGOS entry in float64 on the card's plain route."""
    from repro_torch.core import convex, simulate

    gpu = convex.synthetic("linreg", num_workers=9, seed=0,
                           dtype=torch.float64, device=dev)
    cpu = on_cpu(gpu)
    _, opt = cpu.optimum()
    for algo in simulate.ALGOS:
        reset_counts()
        g, ms = timed_run(torch, lambda: simulate.run(gpu, algo, K=600,
                                                      opt_loss=opt))
        launched = {k: v for k, v in counts().items() if v}
        c, cpu_ms = timed_run(torch, lambda: simulate.run(cpu, algo, K=600,
                                                          opt_loss=opt))
        check(not launched, f"12a {algo}: float64 launched {launched}")
        ops, busy, idle = traced_rounds(torch, lambda: simulate.run(
            gpu, algo, K=20, opt_loss=opt))
        check(g.losses.dtype.name == "float64" and
              bool(torch.isfinite(torch.from_numpy(g.losses)).all()),
              f"12a {algo}: losses {g.losses.dtype}")
        row = to_eps(g, 1e-8)
        check(row == to_eps(c, 1e-8), f"12a {algo}: card {row} vs CPU "
                                      f"{to_eps(c, 1e-8)}")
        if algo not in CONVEX_OWN:
            check(row == CONVEX_TABLE[algo], f"12a {algo}: {row} vs the "
                                             f"reference's "
                                             f"{CONVEX_TABLE[algo]}")
        n, same = masks_through(g, c, 1e-6)
        check(same, f"12a {algo}: masks differ from the CPU run's in "
                    f"rounds 0-{n - 1}")
        # every round's loss through iters_to(1e-6) (all K where it is never
        # reached) and the last round's: the card's steps, aggregates and
        # mirror updates are the CPU's, not only its masks
        err = float(abs(g.losses[:n] / c.losses[:n] - 1.0).max())
        last = float(abs(g.losses[-1] / c.losses[-1] - 1.0))
        check(err <= CONVEX_RTOL64 and last <= CONVEX_RTOL64,
              f"12a {algo}: losses off the CPU's by rtol {err:.3e} in rounds "
              f"0-{n - 1}, {last:.3e} at round {len(g.losses) - 1}")
        ref = CONVEX_TABLE[algo]
        note = {"laq": " with XLA-CPU's quantizer",
                "num-iag": " with jax.random's draw"}.get(algo, "")
        print(f"  12a {algo}: to 1e-8 {row[0]} rounds, {row[1]} uploads, "
              f"{row[2]} B (reference{note} {ref[0]}, {ref[1]}, "
              f"{ref[2]:.0f}); card = CPU; masks equal to the CPU's through "
              f"round {n - 1}, losses within rtol {err:.1e} there and "
              f"{last:.1e} at round {len(g.losses) - 1} (gap "
              f"{g.losses[-1] - opt:.3e}); {g.bytes_per_upload:.0f} B an "
              f"upload; "
              f"L_m_spread {g.extras['L_m_spread']:.3f} hetero_score "
              f"{g.extras['hetero_score']:.3f}; no kernel launched | "
              f"{ms:.3f} ms a round on the card, {cpu_ms:.3f} on the CPU; "
              f"traced: {ops:.0f} device kernels a round busy {busy:.3f} "
              f"ms, device idle {idle}")


def convex_plane_kernels(torch, dev):
    """12b, first: the plane's kernels vs their plain versions at the
    convex path's shapes (9 workers, one (50,) leaf padded to 256 rows)."""
    from repro_torch.fastpath import kernels, kernels_ref
    from repro_torch.fastpath.layout import FlatLayout
    from repro_torch.fastpath.plan import FastPathPlan

    lo = FlatLayout.for_tree(torch.zeros(50, device="meta"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)

    def buf(scale):
        b = lo.empty((9,), dev)
        lo.unflatten_stacked(b).normal_(0.0, scale, generator=gen)
        return b

    a, b, c = buf(1.0), buf(1.0), buf(0.1)
    reset_counts()
    for bb in (b, b[0]):
        torch.testing.assert_close(kernels.delta_sqnorm_blocks(a, bb),
                                   kernels_ref.delta_sqnorm_blocks(a, bb),
                                   rtol=SUM_RTOL, atol=0)
    parts = kernels.absmax_blocks(a, b, c)
    check(bitwise(torch, parts, kernels_ref.absmax_blocks(a, b, c)),
          "12b absmax_blocks not bitwise")
    plan = FastPathPlan("on")
    steps = plan._per_leaf(parts, lo, "max") / torch.full(
        (9, 1), 7.0, device=dev)
    subs = steps[:, plan.sub_leaf(lo, dev)].contiguous()
    p, r, sq = kernels.laq_encode_blocks(a, b, c, subs, 4)
    wp, wr, wsq = kernels_ref.laq_encode_blocks(a, b, c, subs, 4)
    check(bitwise(torch, p, wp) and bitwise(torch, r, wr),
          "12b laq_encode_blocks not bitwise")
    torch.testing.assert_close(sq, wsq, rtol=SUM_RTOL, atol=0)
    mask = torch.tensor([i % 2 == 0 for i in range(9)], device=dev)
    for mode, aa in (("add", a), ("select", a), ("select", a[0])):
        check(bitwise(torch, kernels.masked_combine(aa, b, mask, mode),
                      kernels_ref.masked_combine(aa, b, mask, mode)),
              f"12b masked_combine {mode} not bitwise")
    print(f"  12b kernels at (9, {lo.rows}, 128) vs plain versions: sums "
          f"within rtol {SUM_RTOL}, absmax / encode / masked_combine "
          f"bitwise (comparison launches, not counted: {counts()})")


def convex_plane_float32(torch, dev):
    """12b: the float32 problem on the batched plane; returns the plane's
    launches over the runs."""
    from repro_torch.core import convex, simulate

    gpu = convex.synthetic("linreg", num_workers=9, seed=0,
                           dtype=torch.float32, device=dev)
    cpu = on_cpu(gpu)
    _, opt = cpu.optimum()
    K = 300
    total = {}
    for spec, want in CONVEX_PLANE.items():
        # a cyclic schedule takes IAG's α = 1/(M·L): the default 1/L
        # diverges for cyc-laq (in the reference too)
        kw = dict(K=K, opt_loss=opt, alpha=1.0 / (9 * gpu.L)
                  if spec.startswith("cyc-") else None)
        reset_counts()
        g, ms = timed_run(torch, lambda: simulate.run(gpu, spec, **kw))
        got = counts()
        c, cpu_ms = timed_run(torch, lambda: simulate.run(
            cpu, spec, fastpath="on", **kw))
        ops, busy, idle = traced_rounds(torch, lambda: simulate.run(
            gpu, spec, **dict(kw, K=20)))
        for k, v in got.items():
            n = want.get(k, 0) * K
            check(v == n, f"12b {spec}: {k} launched {v} times in {K} "
                          f"rounds, want {n}")
            total[k] = total.get(k, 0) + v
        laq = "laq" in spec
        # a schedule's masks do not depend on the gradients: all rounds
        eps = LAQ_EPS32 if laq and not spec.startswith("cyc-") \
            else CONVEX_EPS32
        rtol = LAQ_RTOL32 if laq else CONVEX_RTOL32
        n, same = masks_through(g, c, eps)
        first = (g.comm_mask != c.comm_mask).any(axis=1).nonzero()[0]
        check(same, f"12b {spec}: masks differ from the CPU run's in rounds "
                    f"0-{n - 1} (first {first[:3]})")
        err = float(abs(g.losses[:n] / c.losses[:n] - 1.0).max())
        check(err <= rtol, f"12b {spec}: losses off by rtol {err:.3e} in "
                           f"rounds 0-{n - 1}")
        print(f"  12b {spec}: float32 plane, launches "
              f"{ {k: v // K for k, v in got.items() if v} } a round; "
              f"masks equal to the CPU's (fastpath='on') through round "
              f"{n - 1} (iters_to({eps:g}); first difference "
              f"{first[0] if first.size else 'none'} of {K}), losses within "
              f"rtol {err:.2e}; gap at round {K - 1} "
              f"{g.losses[-1] - opt:.3e}; uploads {g.total_comms} | "
              f"{ms:.3f} ms a round on the card, {cpu_ms:.3f} on the CPU; "
              f"traced: {ops:.0f} device kernels a round busy {busy:.3f} "
              f"ms, device idle {idle}")
    return total


def convex_gisette(torch, dev, child):
    """12c: Gisette at the paper's shape, float64; its data from ``child``
    (``cpu_child`` of GISETTE_CHILD)."""
    from repro_torch.core import simulate

    t0 = time.perf_counter()
    cpu, gen_s = child.result()
    wait_s = time.perf_counter() - t0
    gpu = on_cpu(cpu, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, opt = gpu.optimum()
    torch.cuda.synchronize()
    opt_s = time.perf_counter() - t0
    check(math.isfinite(opt), f"12c optimum {opt}")
    print(f"  12c gisette (9 workers x {gpu.X.shape[1]} x {gpu.dim}, "
          f"float64): generated on the host in {gen_s:.1f} s (a CPU-only "
          f"process, {CPU_CHILD_THREADS} threads; waited {wait_s:.1f} s for "
          f"it); optimum() (200,000 GD steps) {opt_s:.1f} s on the card, "
          f"loss {opt!r}")
    for algo in ("gd", "lag-wk"):
        reset_counts()
        g, ms = timed_run(torch, lambda: simulate.run(gpu, algo, K=3000,
                                                      opt_loss=opt))
        launched = {k: v for k, v in counts().items() if v}
        check(not launched, f"12c {algo}: float64 launched {launched}")
        ops, busy, idle = traced_rounds(torch, lambda: simulate.run(
            gpu, algo, K=20, opt_loss=opt))
        c, cpu_ms = timed_run(torch, lambda: simulate.run(cpu, algo, K=20,
                                                          opt_loss=opt))
        check(bool((g.comm_mask[:20] == c.comm_mask).all()),
              f"12c {algo}: the first 20 rounds' masks differ")
        err = float(abs(g.losses[:20] / c.losses - 1.0).max())
        check(err <= 1e-12, f"12c {algo}: the first 20 losses off by "
                            f"rtol {err:.3e}")
        check(bool(torch.isfinite(torch.from_numpy(g.losses)).all()),
              f"12c {algo}: non-finite loss")
        print(f"  12c {algo}: K 3000, to 1e-8 {g.iters_to(1e-8)} rounds, "
              f"{g.comms_to(1e-8)} uploads (total {g.total_comms}); gap at "
              f"round 2999 {g.losses[-1] - opt:.3e}; first 20 rounds: masks "
              f"equal to the CPU's, losses within rtol {err:.1e} | "
              f"{ms:.3f} ms a round on the card, {cpu_ms:.3f} on the CPU; "
              f"traced: {ops:.0f} device kernels a round busy {busy:.3f} "
              f"ms, device idle {idle}")


def convex_cluster(torch, dev):
    """12d: the dial's problem priced on the hetero cluster."""
    from repro_torch.engine import Experiment
    from repro_torch.netsim import hetero_problem

    gpu = hetero_problem("linreg", h=0.8, dtype=torch.float64, device=dev)
    cpu = on_cpu(gpu)
    _, opt = cpu.optimum()
    reports = []
    for prob in (gpu, cpu):
        rep, ms = timed_run(torch, lambda: Experiment(
            problem=prob, algo="lag-wk", steps=600,
            cluster="hetero:9@10ms/1Gbps", opt_loss=opt).run())
        reports.append((rep, ms))
    (g, ms), (c, cpu_ms) = reports
    check(g.seconds_to(1e-8) == c.seconds_to(1e-8) is not None,
          f"12d seconds_to(1e-8) card {g.seconds_to(1e-8)!r} vs CPU "
          f"{c.seconds_to(1e-8)!r}")
    # through the optimum the masks, and so every round's price, are the
    # CPU's; past it the triggers compare round-off of the two devices'
    # float64 products, so the priced tail (and wall_seconds) may differ
    n, same = masks_through(g, c, 1e-6)
    check(same and bool((g.round_seconds[:n] == c.round_seconds[:n]).all()),
          f"12d masks or round seconds differ from the CPU's in rounds "
          f"0-{n - 1}")
    wall_err = abs(g.wall_seconds / c.wall_seconds - 1.0)
    check(wall_err <= WALL_RTOL,
          f"12d wall_seconds card {g.wall_seconds!r} vs CPU "
          f"{c.wall_seconds!r}: rtol {wall_err:.3e} > {WALL_RTOL}")
    differ = (g.comm_mask != c.comm_mask).any(axis=1).nonzero()[0]
    print(f"  12d lag-wk on hetero:9@10ms/1Gbps, h 0.8 (L_m_spread "
          f"{g.extras['L_m_spread']:.3f}): seconds_to(1e-8) "
          f"{g.seconds_to(1e-8)!r} after {g.iters_to(1e-8)} rounds and "
          f"{g.comms_to(1e-8)} uploads, equal to the CPU's, and every round's "
          f"seconds equal through round {n - 1} (iters_to(1e-6)); "
          f"wall_seconds card {g.wall_seconds!r}, CPU {c.wall_seconds!r} "
          f"(rtol {wall_err:.2e}, allowed {WALL_RTOL}): {differ.size} "
          f"rounds past the optimum upload differently "
          f"(from round {differ[0] if differ.size else '-'}) | {ms:.3f} ms a "
          f"round on the card, {cpu_ms:.3f} on the CPU")


# ---------------------------------------------------------------------------
# Phase 13: the deep topologies, the fleet, the deep front door
# ---------------------------------------------------------------------------

def phase13_deep(torch, phase5, steps=4):
    """13a-13c at full width through the launcher: PHASE13's runs, each
    with its kernels' exact launches a round; returns the plane's launches
    over all of them."""
    from repro_torch.engine.topology import AsyncShards

    s = AsyncShards(staleness=1).stale_steps(2).tolist()
    check(s == [0, 1], f"async:2@1 staleness ramp {s}")
    print(f"  13a async:2@1: staleness ramp {s} = the ring's slots, so the "
          f"ring (2 x 4.94 GB) is the stacked view: nothing is gathered")
    total = {}
    for part, algo, extra, want in PHASE13:
        run = trainer_phase(torch, algo, steps=steps, extra=extra)
        label = f"{part} " + " ".join((algo,) + tuple(extra))
        for k, v in run["plane"].items():
            n = want.get(k, 0) * steps
            check(v == n, f"{label}: {k} launched {v} times in {steps} "
                          f"rounds, want {n}")
            total[k] = total.get(k, 0) + v
        check(run["peak"] < 80.0, f"{label}: peak {run['peak']:.2f} GB")
        if "pods:2" in extra:
            # the pods' trajectory is the shards' (phase 5's lag-wk run):
            # a quiet round's deltas are exactly zero
            want5 = phase5["lag-wk"]
            check([r["mask"] for r in run["rounds"]]
                  == [r["mask"] for r in want5]
                  and [r["loss"] for r in run["rounds"]]
                  == [r["loss"] for r in want5],
                  f"{label}: masks or losses differ from phase 5's shards")
            print(f"  {label}: masks and losses bitwise phase 5's shards; "
                  f"rounds_skipped "
                  f"{sum(r['skipped'] for r in run['rounds'])}")
        if "fleet" in extra[1]:
            k = int(extra[1].split("@")[1])
            check(all(len(r["cohort"]) == k for r in run["rounds"]),
                  f"{label}: cohorts {[r['cohort'] for r in run['rounds']]}")
        print(f"  {label}: launches a round "
              f"{ {k: v // steps for k, v in run['plane'].items() if v} }")
    return total


def small_topologies(torch, dev):
    """The reduced model on the card: async:2@0 bitwise shards (losses,
    masks, θ), and pods:2 in a setting with a quiet round (lag-wk at lr
    0.01 on one fixed batch), the card's masks equal to the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_heterogeneous_inputs
    from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                              make_train_step, params_of)
    from repro_torch.engine.topology import make_topology

    cfg = get_config("llama3.2-1b").reduced()

    def run(topology, algo, lr, device, params=None):
        tcfg = TrainerConfig(algo=algo, num_workers=2, lr=lr)
        topo = make_topology(topology)
        st = init_state(cfg, tcfg, device=device, seed=0, params=params,
                        topology=topo)
        step = make_train_step(cfg, tcfg, topology=topo)
        batch = make_heterogeneous_inputs(cfg, TokenStream(cfg.vocab_size),
                                          0, 2, 4, 32, device=device)
        losses, masks = [], []
        for _ in range(3):
            st, m = step(st, batch)
            losses.append(float(m["loss"]))
            masks.append(m["comm_mask"].to(torch.int32).tolist())
        return losses, masks, st, topo

    params = params_of(init_state(cfg, TrainerConfig(num_workers=2),
                                  device="cpu", seed=0), cfg)
    for algo in ("lag-wk", "lag-ps"):
        a_l, a_m, a_st, _ = run("async:2@0", algo, 0.3, dev, params)
        s_l, s_m, s_st, _ = run("shards", algo, 0.3, dev, params)
        check(a_l == s_l and a_m == s_m
              and bitwise(torch, a_st["theta"], s_st["theta"]),
              f"13a {algo}: async:2@0 is not bitwise shards on the card")
        print(f"  13a small {algo}: async:2@0 on the card = shards bit for "
              f"bit (losses {[round(x, 6) for x in a_l]}, masks {a_m}, θ)")
    g_l, g_m, g_st, g_topo = run("pods:2", "lag-wk", 0.01, dev, params)
    c_l, c_m, c_st, _ = run("pods:2", "lag-wk", 0.01, "cpu", params)
    skipped = int(g_st["lag"]["rounds_skipped"])
    check(g_m == c_m, f"13b small: masks card {g_m} vs CPU {c_m}")
    check(all(abs(x - y) <= 1e-4 * abs(y) for x, y in zip(g_l, c_l)),
          f"13b small: losses card {g_l} vs CPU {c_l}")
    check(skipped >= 1 and g_topo.branches["zero"] == skipped,
          f"13b small: rounds_skipped {skipped}, branches "
          f"{g_topo.branches}")
    print(f"  13b small pods:2 lag-wk lr 0.01: masks {g_m} (= the CPU's), "
          f"rounds_skipped {skipped}, reduce branches {g_topo.branches} "
          f"(the quiet round's sum is zeros on the card)")


def convex_fleet_kernels(torch, dev, k=625):
    """13d, first: the plane's kernels at the convex fleet's cohort shape
    (k clients, one (4,) leaf padded to 256 rows) vs their plain
    versions."""
    from repro_torch.fastpath import kernels, kernels_ref
    from repro_torch.fastpath.layout import FlatLayout

    lo = FlatLayout.for_tree(torch.zeros(4, device="meta"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    bufs = []
    for _ in range(2):
        b = lo.empty((k,), dev)
        lo.unflatten_stacked(b).normal_(generator=gen)
        bufs.append(b)
    a, b = bufs
    reset_counts()
    torch.testing.assert_close(kernels.delta_sqnorm_blocks(a, b),
                               kernels_ref.delta_sqnorm_blocks(a, b),
                               rtol=SUM_RTOL, atol=0)
    mask = torch.arange(k, device=dev) % 3 == 0
    check(bitwise(torch, kernels.masked_combine(a, b, mask, "add"),
                  kernels_ref.masked_combine(a, b, mask, "add")),
          "13d masked_combine add not bitwise")
    print(f"  13d kernels at ({k}, {lo.rows}, 128) vs plain versions: "
          f"delta_sqnorm within rtol {SUM_RTOL}, masked_combine bitwise "
          f"(comparison launches, not counted: {counts()})")


def convex_fleet(torch, dev, child):
    """13d: the reference benchmark's scale row on the plane, card against
    CPU (the kernels' plain versions, run by ``child``: ``cpu_child`` of
    FLEET_CHILD), the port's own draws; returns the plane's launches."""
    import numpy as np

    from repro_torch.engine import Experiment
    from repro_torch.fleet import fleet_problem

    N, k, K = FLEET_SCALE
    gpu = fleet_problem("linreg", num_clients=N, n_per=2, d=4,
                        dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    (c, opt), cpu_s = child.result()
    wait_s = time.perf_counter() - t0
    cpu_ms = cpu_s * 1e3 / len(c.losses)
    kw = dict(algo="lag-wk", steps=K, opt_loss=opt,
              topology=f"fleet:{N}@{k}", cluster=f"fleet:{N}@50ms/20Mbps")
    reset_counts()
    g, ms = timed_run(torch, lambda: Experiment(problem=gpu, **kw).run())
    got = counts()
    for name, v in got.items():
        n = CONVEX_FLEET_PLANE.get(name, 0) * K
        check(v == n, f"13d: {name} launched {v} times in {K} rounds, "
                      f"want {n}")
    check(len(c.losses) == K, f"13d: the CPU ran {len(c.losses)} rounds")
    check(np.array_equal(g.extras["cohort_ids"], c.extras["cohort_ids"]),
          "13d: the card drew other cohorts than the CPU")
    n, same = masks_through(g, c, CONVEX_FLEET_EPS)
    first = (g.comm_mask != c.comm_mask).any(axis=1).nonzero()[0]
    check(same, f"13d: masks differ from the CPU's in rounds 0-{n - 1} "
                f"(first {first[:3]})")
    err = float(abs(g.losses[:n] / c.losses[:n] - 1.0).max())
    check(err <= CONVEX_RTOL32, f"13d: losses off the CPU's by rtol "
                                f"{err:.3e} in rounds 0-{n - 1}")
    check(bool(np.isfinite(g.losses).all()), "13d: non-finite loss")
    ops, busy, idle = traced_rounds(torch, lambda: Experiment(
        problem=gpu, **dict(kw, steps=10)).run())
    print(f"  13d fleet_problem('linreg', n_per=2, d=4) float32, N {N}, k "
          f"{k}, K {K}, lag-wk: launches "
          f"{ {name: v // K for name, v in got.items() if v} } a round; "
          f"cohorts equal to the CPU's, masks equal through round {n - 1} "
          f"(iters_to({CONVEX_FLEET_EPS:g}); iters_to(1e-4) "
          f"{g.iters_to(1e-4)}; first difference "
          f"{first[0] if first.size else 'none'} of {K}, {first.size} "
          f"rounds differ), losses "
          f"within rtol {err:.2e}; gap round 0 {g.losses[0] - opt:.6g}, round "
          f"{K - 1} {g.losses[-1] - opt:.6g}; uploads {g.total_comms} of "
          f"{K * k}, most in a round {int(g.comms_per_iter.max())}; priced "
          f"on fleet:{N}@50ms/20Mbps: wall_seconds card {g.wall_seconds!r}, "
          f"CPU {c.wall_seconds!r} | {ms:.3f} ms a round on the card, "
          f"{cpu_ms:.3f} on the CPU (a CPU-only process, "
          f"{CPU_CHILD_THREADS} threads, beside phases 3-13; waited "
          f"{wait_s:.1f} s for it); traced: {ops:.0f} device kernels a "
          f"round busy {busy:.3f} ms, device idle {idle}")
    return got


def experiment_cluster(torch, steps=4):
    """13e: Experiment(model=…, reduced=False, hetero=0.8, cluster=…)
    against the launcher's --hetero 0.8 --cluster on the same rounds: the
    same masks, losses and priced seconds."""
    import contextlib
    import io

    import numpy as np

    from repro_torch.engine import Experiment
    from repro_torch.launch import train
    from repro_torch.netsim import make_cluster, price_mask

    cluster = "hetero:2@10ms/1Gbps"
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    rep, ms = timed_run(torch, lambda: Experiment(
        model="llama3.2-1b", reduced=False, topology="shards", algo="lag-wk",
        workers=2, lr=0.3, batch=4, seq=256, steps=steps, hetero=0.8,
        fixed_batch=False, cluster=cluster).run())
    got = counts()
    gc.collect()
    torch.cuda.empty_cache()
    masks, losses = [], []
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(["--arch", "llama3.2-1b", "--algo", "lag-wk", "--workers",
                    "2", "--batch", "4", "--seq", "256", "--steps",
                    str(steps), "--seed", "0", "--hetero", "0.8",
                    "--cluster", cluster],
                   on_step=lambda s, m, t: (
                       masks.append(m["comm_mask"].cpu().numpy()),
                       losses.append(float(m["loss"]))))
    line = [x for x in out.getvalue().splitlines()
            if x.startswith("simulated wall-clock")]
    check(len(line) == 1, f"13e: the launcher printed {line}")
    check(np.array_equal(np.stack(masks), rep.comm_mask)
          and np.array_equal(np.asarray(losses, np.float32), rep.losses),
          f"13e: launcher masks/losses {masks} {losses} vs Experiment's "
          f"{rep.comm_mask.tolist()} {rep.losses.tolist()}")
    priced = price_mask(np.stack(masks), rep.bytes_per_upload,
                        make_cluster(cluster, num_workers=2),
                        dense_bytes=rep.bytes_per_upload).sum()
    check(float(priced) == rep.wall_seconds and
          f"{rep.wall_seconds:.2f}s" in line[0],
          f"13e: launcher {line[0]!r} / {priced!r} vs Experiment "
          f"{rep.wall_seconds!r}")
    for name in ("delta_sqnorm_blocks", "masked_combine"):
        check(got[name] == steps, f"13e: {name} launched {got[name]} times")
    print(f"  13e Experiment(model='llama3.2-1b', reduced=False, hetero=0.8, "
          f"cluster='{cluster}'): wall_seconds {rep.wall_seconds!r} "
          f"(hetero_dial {rep.extras['hetero_dial']}), masks "
          f"{rep.comm_mask.astype(int).tolist()}, the launcher's on the same "
          f"rounds: {line[0]!r} | {ms:.1f} ms a round, set-up included")
    return got


# ---------------------------------------------------------------------------
# Phase 14: the gossip graph, the launcher's checkpoints
# ---------------------------------------------------------------------------

def graph_full_width(torch, steps=4):
    """14a: graph:2@ring through the launcher at full width; returns the
    plane's launches."""
    total = {}
    for algo, want in PHASE14A:
        run = trainer_phase(torch, algo, steps=steps,
                            extra=("--topology", "graph:2@ring"))
        label = f"14a {algo} graph:2@ring"
        check(all(len(r["mask"]) == 2 for r in run["rounds"]),
              f"{label}: masks {[r['mask'] for r in run['rounds']]}")
        for k, v in run["plane"].items():
            n = want.get(k, 0) * steps
            check(v == n, f"{label}: {k} launched {v} times in {steps} "
                          f"rounds, want {n}")
            total[k] = total.get(k, 0) + v
        check(run["peak"] < 80.0, f"{label}: peak {run['peak']:.2f} GB")
        print(f"  {label}: launches a round "
              f"{ {k: v // steps for k, v in run['plane'].items() if v} }")
    return total


def graph_experiment(torch, dev, steps=4):
    """14b: Experiment(model=<2 layers, full width>, graph:4@ring) lag-wk,
    then the reduced model card against CPU; returns the launches."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.engine import Experiment

    cfg = get_config("llama3.2-1b", num_layers=2)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rep, ms = timed_run(torch, lambda: Experiment(
        model=cfg, topology="graph:4@ring", algo="lag-wk", lr=0.3, batch=4,
        seq=256, steps=steps, device=dev).run())
    got = counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    E = len(rep.extras["edge_src"])
    check(E == 8 and rep.comm_mask.shape == (steps, 8),
          f"14b: E {E}, mask {rep.comm_mask.shape}")
    check(bool(rep.comm_mask[0].all()), "14b: round 0 must fire every edge")
    check(bool(np.isfinite(rep.losses).all()), "14b: non-finite loss")
    for k, v in got.items():
        n = PHASE14A[0][1].get(k, 0) * steps
        check(v == n, f"14b: {k} launched {v} times in {steps} rounds, "
                      f"want {n}")
    check(peak < 80.0, f"14b: peak {peak:.2f} GB")
    print(f"  14b Experiment(model=<llama3.2-1b, 2 layers, full width>, "
          f"topology='graph:4@ring') lag-wk: E {E}, masks "
          f"{rep.comm_mask.astype(int).tolist()}, losses "
          f"{[round(float(x), 6) for x in rep.losses]}, launches a round "
          f"{ {k: v // steps for k, v in got.items() if v} }, peak "
          f"{peak:.2f} GB, {ms:.1f} ms a round (set-up included)")
    del rep
    # the same configuration through the launcher: the round's phases
    run = trainer_phase(torch, "lag-wk", steps=steps,
                        extra=("--layers", "2", "--topology", "graph:4@ring"))
    check(all(len(r["mask"]) == 8 for r in run["rounds"]),
          f"14b launcher: masks {[r['mask'] for r in run['rounds']]}")
    for k, v in run["plane"].items():
        n = PHASE14A[0][1].get(k, 0) * steps
        check(v == n, f"14b launcher: {k} launched {v} times in {steps} "
                      f"rounds, want {n}")
        got[k] = got.get(k, 0) + v
    check(run["peak"] < 80.0, f"14b launcher: peak {run['peak']:.2f} GB")
    graph_small_agreement(torch, dev)
    return got


def graph_small_agreement(torch, dev):
    """14b: the reduced model's graph:4@ring on the card (kernels) and on
    the CPU (plain versions) from the same weights, ξ = 10 so that edges
    go quiet."""
    from repro_torch import graph
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_heterogeneous_inputs
    from repro_torch.dist.lag_trainer import (TrainerConfig, init_params,
                                              param_layout)
    from repro_torch.engine.topology import make_topology

    cfg = get_config("llama3.2-1b").reduced()
    topo = make_topology("graph:4@ring")
    params = param_layout(cfg).unflatten(init_params(cfg, device="cpu",
                                                     seed=5))
    batch = make_heterogeneous_inputs(cfg, TokenStream(cfg.vocab_size), 0,
                                      4, 8, 32, device="cpu")
    for algo in ("lag-wk", "laq@4"):
        tcfg = TrainerConfig(algo=algo, num_workers=4, lr=0.3, xi=10.0)
        runs = {}
        for where, fp in (("cpu", "on"), ("gpu", "auto")):
            d = "cpu" if where == "cpu" else dev
            t = tcfg.replace(fastpath=fp)
            st = graph.init_graph_state(cfg, t, topo, device=d,
                                        params=params)
            step = graph.make_graph_step(cfg, t, topo)
            b = {k: v.to(d) for k, v in batch.items()}
            losses, masks = [], []
            for _ in range(3):
                st, m = step(st, b)
                losses.append(float(m["loss"]))
                masks.append(m["comm_mask"].to(torch.int32).tolist())
            runs[where] = (losses, masks)
        (lc, mc), (lg, mg) = runs["cpu"], runs["gpu"]
        check(mc == mg, f"14b small {algo}: masks card {mg} vs CPU {mc}")
        check(all(abs(x - y) <= 1e-4 * abs(y) for x, y in zip(lg, lc)),
              f"14b small {algo}: losses card {lg} vs CPU {lc}")
        print(f"  14b small graph:4@ring {algo} ξ 10: card = CPU masks "
              f"{mg}, losses within rtol 1e-4 ({[round(x, 6) for x in lg]})")


def graph_convex(torch, dev):
    """14c: the convex graph, float64 card vs CPU, float32 plane card vs
    CPU, priced; returns the plane's launches."""
    import numpy as np

    from repro_torch.core import convex
    from repro_torch.engine import Experiment
    from repro_torch.netsim import make_cluster, price_edge_mask

    total = {}
    for dt in (torch.float64, torch.float32):
        gpu = convex.synthetic("linreg", dtype=dt, device=dev,
                               **GRAPH_PROBLEM)
        cpu = on_cpu(gpu)
        _, opt = cpu.optimum()
        for fam in GRAPH_FAMILIES:
            reps = {}
            for algo in GRAPH_PLANE:
                kw = dict(algo=algo, steps=GRAPH_K, opt_loss=opt,
                          topology=f"graph:9@{fam}")
                reset_counts()
                g, ms = timed_run(torch, lambda: Experiment(
                    problem=gpu, **kw).run())
                got = counts()
                c, cpu_ms = timed_run(torch, lambda: Experiment(
                    problem=cpu, fastpath=None if dt == torch.float64
                    else "on", **kw).run())
                reps[algo] = (g, c, ms, cpu_ms, got)
            # the family's matched ε (graph_sweep.py's): the slowest algo's
            # final gap on the CPU
            eps = 1.001 * max(float(c.losses[-1] - opt)
                              for _, c, _, _, _ in reps.values())
            for algo, (g, c, ms, cpu_ms, got) in reps.items():
                label = f"14c {str(dt)[6:]} graph:9@{fam} {algo}"
                E = g.extras["num_edges"]
                check(g.comm_mask.shape == (GRAPH_K, E),
                      f"{label}: mask {g.comm_mask.shape}")
                check(bool(np.isfinite(g.losses).all()),
                      f"{label}: non-finite loss")
                if dt == torch.float64:
                    check(not any(got.values()),
                          f"{label}: float64 launched {got}")
                    row, want = (g.iters_to(eps), g.comms_to(eps)), \
                        (c.iters_to(eps), c.comms_to(eps))
                    check(row == want, f"{label}: to {eps:.4g} card {row} vs "
                                       f"CPU {want}")
                    n, same = masks_through(g, c, eps)
                    rtol = CONVEX_RTOL64
                else:
                    for k, v in got.items():
                        want_n = GRAPH_PLANE[algo].get(k, 0) * GRAPH_K
                        check(v == want_n, f"{label}: {k} launched {v} times "
                                           f"in {GRAPH_K} rounds, want "
                                           f"{want_n}")
                        total[k] = total.get(k, 0) + v
                    n, same = masks_through(g, c, 1e-2)
                    rtol = 1e-4
                check(same, f"{label}: masks differ from the CPU's in rounds "
                            f"0-{n - 1}")
                err = float(abs(g.losses[:n] / c.losses[:n] - 1.0).max())
                check(err <= rtol, f"{label}: losses off the CPU's by rtol "
                                   f"{err:.3e} in rounds 0-{n - 1}")
                first = (g.comm_mask != c.comm_mask).any(axis=1).nonzero()[0]
                print(f"  {label}: E {E}, to the matched ε {eps:.4g}: "
                      f"{g.iters_to(eps)} rounds, {g.comms_to(eps)} uploads "
                      f"(CPU {c.iters_to(eps)}, {c.comms_to(eps)}); masks "
                      f"equal through round {n - 1} (first difference "
                      f"{first[0] if first.size else 'none'}), losses within "
                      f"rtol {err:.1e}; uploads {g.total_comms} of "
                      f"{GRAPH_K * E}; consensus "
                      f"{g.extras['consensus_final']:.3e}; launches a round "
                      f"{ {k: v // GRAPH_K for k, v in got.items() if v} } | "
                      f"{ms:.3f} ms a round on the card, {cpu_ms:.3f} on the "
                      f"CPU")
            if dt == torch.float64 and fam == "ring":
                # the Experiment's pricing against the launcher's
                g = reps["lag-wk"][0]
                E = g.extras["num_edges"]
                cluster = f"hetero:{E}@10ms/1Gbps"
                priced = Experiment(problem=gpu, algo="lag-wk", steps=GRAPH_K,
                                    opt_loss=opt, topology=f"graph:9@{fam}",
                                    cluster=cluster).run()
                dense = float(gpu.dim * gpu.X.element_size())
                want = price_edge_mask(priced.comm_mask,
                                       priced.bytes_per_upload,
                                       make_cluster(cluster, num_workers=E),
                                       priced.extras["edge_dst"],
                                       dense_bytes=dense).sum()
                check(priced.wall_seconds == float(want),
                      f"14c priced: Experiment {priced.wall_seconds!r} vs "
                      f"price_edge_mask {want!r}")
                print(f"  14c priced graph:9@ring lag-wk on '{cluster}': "
                      f"wall_seconds {priced.wall_seconds!r} = the "
                      f"launcher's price_edge_mask of the same rounds")
    return total


def graph_resume(torch, steps=4, at=2):
    """14d: rounds at+1..steps resumed from a checkpoint equal the
    uninterrupted run's bit for bit (masks, losses, θ)."""
    import shutil
    import tempfile

    from repro_torch.launch import train

    base = ["--arch", "llama3.2-1b", "--layers", "2", "--algo", "lag-wk",
            "--workers", "2", "--batch", "4", "--seq", "256", "--seed", "0"]
    for topology in ("shards", "graph:2@ring"):
        runs = {}
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            for name, extra in (
                    ("whole", ["--steps", str(steps)]),
                    ("first", ["--steps", str(at), "--ckpt-dir", tmp,
                               "--ckpt-every", str(at)]),
                    ("resumed", ["--steps", str(steps), "--ckpt-dir", tmp,
                                 "--resume"])):
                rounds = {}
                gc.collect()
                torch.cuda.empty_cache()
                t0 = time.perf_counter()
                state = train.main(
                    base + ["--topology", topology] + extra,
                    on_step=lambda k, m, t: rounds.update(
                        {k: (float(m["loss"]), m["comm_mask"].tolist())}))
                torch.cuda.synchronize()
                runs[name] = (rounds, state["theta"].cpu(),
                              time.perf_counter() - t0)
                del state
            ckpt_gb = sum(os.path.getsize(os.path.join(tmp, f))
                          for f in os.listdir(tmp)) / 1e9
        finally:
            shutil.rmtree(tmp)
        whole, resumed = runs["whole"], runs["resumed"]
        check(sorted(resumed[0]) == list(range(at, steps)),
              f"14d {topology}: resumed rounds {sorted(resumed[0])}")
        same = all(resumed[0][k] == whole[0][k] for k in range(at, steps))
        check(same, f"14d {topology}: resumed rounds "
                    f"{resumed[0]} vs uninterrupted {whole[0]}")
        check(bitwise(torch, resumed[1], whole[1]),
              f"14d {topology}: resumed θ differs from the uninterrupted")
        print(f"  14d {topology} lag-wk, 2 layers at full width: rounds "
              f"{at + 1}-{steps} resumed from step {at} equal the "
              f"uninterrupted ones bit for bit (losses, masks "
              f"{[resumed[0][k][1] for k in range(at, steps)]}, θ); "
              f"checkpoint {ckpt_gb:.2f} GB; runs {whole[2]:.1f} / "
              f"{runs['first'][2]:.1f} + {resumed[2]:.1f} s (save + restore "
              f"included)")


# ---------------------------------------------------------------------------
# Phase 15: every architecture of the dense block kind
# ---------------------------------------------------------------------------

def flash_ragged(torch, dev, gen, hd, H, KV, bad):
    """Flash attention at (head_dim, H, KV) on phase 7's ragged set against
    its plain version; a case beyond rtol = atol = MODEL_TOL goes to
    ``bad``.  Prints the largest error."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    cases = [(S, S, c, w) for S in FLASH_S for c, w in FLASH_MASKS]
    cases += FLASH_CROSS
    worst = 0.0
    for S, Skv, causal, window in cases:
        q = torch.randn((1, S, H, hd), device=dev, generator=gen)
        k = torch.randn((1, Skv, KV, hd), device=dev, generator=gen)
        v = torch.randn((1, Skv, KV, hd), device=dev, generator=gen)
        got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
        want = fa_ref.attention(q, k, v, causal=causal, window=window)
        if S > Skv and window is not None:   # rows that see no key
            live = torch.arange(S, device=dev) - window + 1 < Skv
            got, want = got[:, live], want[:, live]
        err = max_abs(got, want)
        worst = max(worst, err)
        if not (bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, rtol=MODEL_TOL, atol=MODEL_TOL)):
            bad.append(f"flash hd {hd} H {H}/{KV} Sq {S} Skv {Skv} causal "
                       f"{causal} window {window}: {err:.3e}")
    print(f"  flash_attention hd {hd} H {H}/{KV}: {len(cases)} ragged cases, "
          f"max_abs_err {worst:.3e}")


def flash_full(torch, dev, gen, shape, causal, bad):
    """Flash attention at a prefill's (B, S, H, KV, hd) against its plain
    version, timed beside its split-TF32 bound, the plain version and
    ``F.scaled_dot_product_attention``: a row for ``print_full_rows``."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, S, H, KV, hd = shape
    q = torch.randn((B, S, H, hd), device=dev, generator=gen)
    k = torch.randn((B, S, KV, hd), device=dev, generator=gen)
    v = torch.randn((B, S, KV, hd), device=dev, generator=gen)
    run = lambda: fa.flash_attention_fwd(q, k, v, causal=causal)
    plain = lambda: fa_ref.attention(q, k, v, causal=causal)
    got, want = run(), plain()
    err = max_abs(got, want)
    if not (bool(torch.isfinite(got).all()) and torch.allclose(
            got, want, rtol=MODEL_TOL, atol=MODEL_TOL)):
        bad.append(f"flash full {shape}: {err:.3e}")
    del got, want
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    flop = 4 * B * H * hd * (S * (S + 1) // 2 if causal else S * S)
    t_b, by = bound_ms(nbytes, 3 * flop, TF32_FLOP_PER_S)
    return dict(what=f"flash_attention ({B}, {S}, {H}/{KV}, {hd}) "
                     f"{'causal' if causal else 'non-causal'}",
                max_abs_err=err, ms=cuda_ms(torch, run, n=10),
                plain_ms=cuda_ms(torch, plain, n=3), bound_ms=t_b,
                bound_by=by, gflop=flop / 1e9,
                library_ms=cuda_ms(
                    torch, lambda: torch.nn.functional.
                    scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True),
                    n=10))


def print_full_rows(rows):
    for r in rows:
        extra = (f" ({r['gflop']:.1f} GFLOP, 3 TF32 passes at "
                 f"{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s)"
                 if "gflop" in r else "")
        print(f"  full-shape {r['what']}: max_abs_err {r['max_abs_err']:.3e}"
              f" | {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms by {r['bound_by']}{extra} = "
              f"{r['bound_ms'] / r['ms']:.1%}, library "
              f"{r['library_ms']:.4f} ms, kernel / library "
              f"{r['ms'] / r['library_ms']:.3f})")


def wide_kernel_phase(torch, dev):
    """15a: flash attention at head_dim 80 and 128 on phase 7's ragged set
    and at the new archs' prefill shapes, RMSNorm at their widths; each
    against its plain version, the full shapes timed against their bounds
    and one PyTorch call each."""
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rms

    gen = torch.Generator(device=dev)
    gen.manual_seed(15)
    bad, rows = [], []

    def compare(what, got, want):
        err = max_abs(got, want)
        if not (bool(torch.isfinite(got).all()) and torch.allclose(
                got, want, rtol=MODEL_TOL, atol=MODEL_TOL)):
            bad.append(f"{what}: {err:.3e}")
        return err

    for hd, H, KV in WIDE_RAGGED:
        flash_ragged(torch, dev, gen, hd, H, KV, bad)
    for d in RMS_WIDE:
        worst = 0.0
        for r in (1, 7, 129, 1000):
            x = torch.randn((r, d), device=dev, generator=gen)
            sc = torch.randn((d,), device=dev, generator=gen)
            worst = max(worst, compare(f"rmsnorm ({r}, {d})",
                                       rms.rmsnorm_2d(x, sc),
                                       rms_ref.rmsnorm(x, sc)))
        print(f"  rmsnorm d {d}: rows 1, 7, 129, 1000, max_abs_err "
              f"{worst:.3e}")

    for B, S, H, KV, hd, causal in ATTN_WIDE:
        rows.append(flash_full(torch, dev, gen, (B, S, H, KV, hd), causal,
                               bad))
    R = RMS_FULL[0]
    for d in RMS_WIDE:
        x = torch.randn((R, d), device=dev, generator=gen)
        sc = torch.randn((d,), device=dev, generator=gen)
        err = compare(f"rmsnorm full ({R}, {d})", rms.rmsnorm_2d(x, sc),
                      rms_ref.rmsnorm(x, sc))
        t_b, by = bound_ms(2 * R * d * 4 + d * 4, 4 * R * d)
        rd = rms_readings(torch, rms_rotation(torch, gen, x, sc))
        print(rms_reading_line(f"rmsnorm ({R}, {d})", rd, t_b))
        rows.append(dict(
            what=f"rmsnorm ({R}, {d}), device-only", max_abs_err=err,
            ms=rd["kernel"]["device_ms"],
            plain_ms=cuda_ms(torch, lambda: rms_ref.rmsnorm(x, sc), n=20),
            bound_ms=t_b, bound_by=by,
            library_ms=rd["library"]["device_ms"]))
        del x, sc
    print_full_rows(rows)
    check(not bad, f"kernel vs plain beyond rtol = atol = {MODEL_TOL}: "
                   f"{bad}")
    gc.collect()
    torch.cuda.empty_cache()


def dense_kind_serve(torch, dev):
    """15b: the five decoder archs through ``launch.serve`` at full width
    (command-r-35b's depth cut to fit the card)."""
    from repro_torch.configs import get_config

    total = {}
    for arch, argv, layers in SERVE_WIDE:
        cfg = get_config(arch)
        if layers is not None:
            cfg = cfg.replace(num_layers=layers)
        got, _ = serve_phase(torch, dev, ["--arch", arch, *argv], cfg=cfg)
        for k_, v in got.items():
            total[k_] = total.get(k_, 0) + v
    return total


def hubert_forward(torch, dev):
    """15c: hubert-xlarge's forward at full width, the kernel route against
    the plain route on the card; ``launch.serve`` refuses it."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.rmsnorm import rmsnorm as rms
    from repro_torch.launch import serve
    from repro_torch.models import model

    cfg = get_config("hubert-xlarge")
    try:
        serve.main(["--arch", "hubert-xlarge", "--batch", "1",
                    "--prompt-len", "8", "--gen", "2", "--rounds", "1"])
    except SystemExit as e:
        refusal = str(e)
    else:
        raise RuntimeError("chip_smoke check failed: launch.serve served "
                           "hubert-xlarge")
    check("encoder-only architecture has no decode step" in refusal,
          f"hubert refusal: {refusal!r}")
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init(cfg, device=dev, seed=0)
    B, S = HUBERT_FORWARD
    batch = make_inputs(cfg, TokenStream(cfg.vocab_size), 0, B, S,
                        device=dev)
    torch.cuda.reset_peak_memory_stats()
    out, ms = {}, {}
    with torch.inference_mode():
        for up in (True, False):
            c = cfg.replace(use_pallas=up)
            model.forward(params, c, batch)            # warm-up
            rms.reset_launches()
            fa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[up] = model.forward(params, c, batch)
            torch.cuda.synchronize()
            ms[up] = (time.perf_counter() - t0) * 1e3
            if up:
                launches = {"rmsnorm": rms.LAUNCHES["rmsnorm"],
                            "flash_attention": fa.LAUNCHES["flash_attention"]}
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(tuple(out[True].shape) == (B, S, cfg.vocab_size)
          and bool(torch.isfinite(out[True]).all()),
          f"hubert forward: logits {tuple(out[True].shape)}")
    err = max_abs(out[True], out[False])
    check(launches == {"rmsnorm": 0, "flash_attention": cfg.num_layers},
          f"hubert forward launches {launches} (LayerNorm has no kernel)")
    print(f"  hubert-xlarge forward ({B}, {S}) full width and depth: kernel "
          f"route {ms[True]:.1f} ms, plain route {ms[False]:.1f} ms | "
          f"logits max_abs_err {err:.3e} | peak {peak:.2f} GB | launches "
          f"{launches} | launch.serve refuses: {refusal!r}")
    check(err <= SERVE_TOL, f"hubert forward differs by {err} > {SERVE_TOL}")
    del params, batch, out
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dense_kind_training(torch):
    """15d: hubert-xlarge (full width and depth) and qwen2-vl-7b (full
    width, 2 layers) through ``launch.train``, W = 2, batch 4, seq 256."""
    want = {"lag-wk": ("delta_sqnorm_blocks", "masked_combine"),
            "laq@4": ("absmax_blocks", "laq_encode_blocks",
                      "masked_combine")}
    total = {}
    for arch, algo, extra in TRAIN_WIDE:
        run = trainer_phase(torch, algo, extra=extra, arch=arch)
        for k_ in want[algo]:
            check(run["plane"][k_] >= 4, f"{arch} {algo}: kernel {k_} "
                                         f"launched {run['plane'][k_]} times")
        check(run["peak"] < 80.0, f"{arch} {algo}: peak {run['peak']:.2f} "
                                  f"GB")
        for k_, v in run["plane"].items():
            total[k_] = total.get(k_, 0) + v
    return total


def reduced_agreement(torch, dev, cfgs):
    """15e, 16d: reduced configs, 3 rounds of lag-wk on the card (the
    plane's kernels) and on the CPU (their plain versions) from the same
    weights: equal masks, losses within rtol 1e-4."""
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                              make_train_step, params_of)

    tcfg = TrainerConfig(algo="lag-wk", num_workers=2, lr=0.3)
    for cfg in cfgs:
        arch = f"{cfg.arch_id} ({cfg.num_layers} layers)"
        cpu = init_state(cfg, tcfg, device="cpu", seed=5)
        gpu = init_state(cfg, tcfg, device=dev, params=params_of(cpu, cfg))
        cpu_step = make_train_step(cfg, tcfg.replace(fastpath="on"))
        gpu_step = make_train_step(cfg, tcfg)
        stream, masks = TokenStream(cfg.vocab_size, seed=5), []
        for k in range(3):
            b = make_inputs(cfg, stream, k, 4, 32, device="cpu")
            cpu, mc = cpu_step(cpu, b)
            gpu, mg = gpu_step(gpu, {n: t.to(dev) for n, t in b.items()})
            lc, lg = float(mc["loss"]), float(mg["loss"])
            check(abs(lc - lg) <= 1e-4 * abs(lc),
                  f"small {arch} round {k}: loss cpu {lc} vs gpu {lg}")
            check(mc["comm_mask"].tolist() == mg["comm_mask"].cpu().tolist(),
                  f"small {arch} round {k}: masks differ")
            masks.append(mg["comm_mask"].to(torch.int32).tolist())
        print(f"  small {arch} lag-wk: 3 rounds, GPU vs CPU losses within "
              f"rtol 1e-4, masks equal (last loss {lg:.6f}, masks {masks})")


# ---------------------------------------------------------------------------
# Phase 16: the recurrent and state-space layer kinds
# ---------------------------------------------------------------------------

def hd256_kernel_phase(torch, dev):
    """16a: flash attention at head_dim 256 (recurrentgemma's lattn: H 16,
    one KV head; and GQA 8/2) on phase 7's ragged set, then at the serving
    shape (2, 4096, 16/1, 256) causal with window 2048, timed against its
    split-TF32 bound (the (query, key) pairs the masks leave), the plain
    version and ``F.scaled_dot_product_attention`` (float32, the window as
    a boolean mask, ``enable_gqa``)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    bad = []
    for H, KV in HD256_RAGGED:
        flash_ragged(torch, dev, gen, 256, H, KV, bad)

    B, S, H, KV, hd, window = ATTN_HD256
    q = torch.randn((B, S, H, hd), device=dev, generator=gen)
    k = torch.randn((B, S, KV, hd), device=dev, generator=gen)
    v = torch.randn((B, S, KV, hd), device=dev, generator=gen)
    run = lambda: fa.flash_attention_fwd(q, k, v, window=window)
    plain = lambda: fa_ref.attention(q, k, v, window=window)
    got, want = run(), plain()
    err = max_abs(got, want)
    if not torch.allclose(got, want, rtol=MODEL_TOL, atol=MODEL_TOL):
        bad.append(f"full shape: {err:.3e}")
    # the same against a float64 evaluation of the plain version: which
    # side the float32 difference sits on
    want64 = fa_ref.attention(q.double(), k.double(), v.double(),
                              window=window)
    err64 = (max_abs(got.double(), want64), max_abs(want.double(), want64))
    del got, want, want64
    pos = torch.arange(S, device=dev)
    mask = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < window)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    # (query, key) pairs the causal window leaves, 4·hd FLOP each, run as
    # three TF32 products on the tensor cores
    pairs = B * H * sum(min(i + 1, window) for i in range(S))
    flop = 4 * hd * pairs
    nbytes = 4 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    t_b, by = bound_ms(nbytes, 3 * flop, TF32_FLOP_PER_S)
    r = dict(ms=cuda_ms(torch, run, n=10),
             plain_ms=cuda_ms(torch, plain, n=3), bound_ms=t_b, bound_by=by,
             fma_bound_ms=bound_ms(nbytes, flop)[0],
             library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, attn_mask=mask, enable_gqa=True), n=10))
    print(f"  full-shape flash_attention {ATTN_HD256[:5]} causal window "
          f"{window}: max_abs_err {err:.3e} (float64 plain: kernel "
          f"{err64[0]:.3e}, float32 plain {err64[1]:.3e}) | {r['ms']:.4f} ms "
          f"(plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
          f"{by}: {pairs} pairs, 3 x {flop / 1e9:.1f} GFLOP at "
          f"{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s = "
          f"{r['bound_ms'] / r['ms']:.1%}; FMA units {r['fma_bound_ms']:.4f}"
          f" ms; library {r['library_ms']:.4f} ms, kernel / library "
          f"{r['ms'] / r['library_ms']:.3f})")
    check(not bad, f"flash hd 256 vs plain beyond rtol = atol = {MODEL_TOL}:"
                   f" {bad}")
    del q, k, v, qt, kt, vt, mask
    gc.collect()
    torch.cuda.empty_cache()


def recurrent_serve(torch, dev):
    """16b: recurrentgemma-9b (past its window: the rolling cache wraps)
    and mamba2-370m (8 SSD chunks) through ``launch.serve`` at full width
    and depth."""
    total = {}
    for arch, argv in SERVE_RECURRENT:
        got, _ = serve_phase(torch, dev, ["--arch", arch, *argv])
        for k_, v in got.items():
            total[k_] = total.get(k_, 0) + v
    return total


def tree_gb(cfg):
    """The parameter tree's GB (shape-only: no memory is taken)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import model
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(model.templates(cfg))) / 1e9


def reckon_training_cut(cfg, cuts=TRAIN_CUTS, algos=("lag-wk",)):
    """16c, 17c: the first training cut (layers, workers) of ``cuts`` whose
    peak, reckoned by ``repro_torch.launch.dryrun`` for each of ``algos``
    in phase 5's configuration, is under TRAIN_RECKON_GB (the dry-run's
    peaks were within 0.1 % of the measured ones, PERF.md §5)."""
    from repro_torch.dist.lag_trainer import TrainerConfig

    chosen = None
    for layers, workers in cuts:
        cut = cfg.replace(num_layers=layers)
        peak = max(reckoned_peak_gb(cut, TrainerConfig(
            algo=algo, num_workers=workers, lr=0.3)) for algo in algos)
        print(f"  reckoned {cfg.arch_id} --layers {layers} W={workers}: "
              f"peak {peak:.2f} GB ({', '.join(algos)}; the dry-run) = "
              f"{peak / tree_gb(cut):.2f} trees of {tree_gb(cut):.3f} GB")
        if peak < TRAIN_RECKON_GB:
            chosen = (layers, workers)
            break
    check(chosen is not None, f"no training cut of {cfg.arch_id} reckons "
                              f"under {TRAIN_RECKON_GB} GB")
    print(f"  chosen: --layers {chosen[0]} at W={chosen[1]}")
    return chosen, tree_gb(cfg.replace(num_layers=chosen[0]))


def recurrent_training(torch):
    """16c: mamba2-370m (full width and depth) lag-wk and laq@4 at W = 2,
    recurrentgemma-9b at full width at the reckoned cut, through
    ``launch.train`` in phase 5's configuration."""
    from repro_torch.configs import get_config

    want = {"lag-wk": ("delta_sqnorm_blocks", "masked_combine"),
            "laq@4": ("absmax_blocks", "laq_encode_blocks",
                      "masked_combine")}
    (layers, workers), tree = reckon_training_cut(
        get_config("recurrentgemma-9b"))
    runs = [("mamba2-370m", "lag-wk", (), 2), ("mamba2-370m", "laq@4", (), 2),
            ("recurrentgemma-9b", "lag-wk", ("--layers", str(layers)),
             workers)]
    total = {}
    for arch, algo, extra, w in runs:
        run = trainer_phase(torch, algo, extra=extra, arch=arch, workers=w)
        for k_ in want[algo]:
            check(run["plane"][k_] >= 4, f"{arch} {algo}: kernel {k_} "
                                         f"launched {run['plane'][k_]} times")
        check(run["peak"] < 80.0, f"{arch} {algo}: peak {run['peak']:.2f} "
                                  f"GB")
        for k_, v in run["plane"].items():
            total[k_] = total.get(k_, 0) + v
    print(f"  recurrentgemma-9b --layers {layers} W={workers}: peak "
          f"{run['peak']:.2f} GB = {run['peak'] / tree:.2f} trees of "
          f"{tree:.3f} GB")
    return total


# ---------------------------------------------------------------------------
# Phase 17: the moe layer kind
# ---------------------------------------------------------------------------

def moe_kernel_phase(torch, dev):
    """17a: flash attention at the MoE archs' head counts (GQA 32/4 and
    64/4 at head_dim 128) on phase 7's ragged set, then at their prefill
    shapes timed against the split-TF32 bound, the plain version and
    ``F.scaled_dot_product_attention``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    bad = []
    for _, _, H, KV, hd in ATTN_MOE:
        flash_ragged(torch, dev, gen, hd, H, KV, bad)
    print_full_rows([flash_full(torch, dev, gen, shape, True, bad)
                     for shape in ATTN_MOE])
    check(not bad, f"flash at the MoE head counts vs plain beyond rtol = "
                   f"atol = {MODEL_TOL}: {bad}")
    gc.collect()
    torch.cuda.empty_cache()


def moe_serve(torch, dev):
    """17b: qwen3-moe-30b-a3b at 24 of 48 layers and qwen3-moe-235b-a22b at
    5 of 94 through ``launch.serve`` at full width (phase 8's run and
    checks), with the share of the reckoned float32 products."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    total = {}
    for arch, layers in SERVE_MOE:
        cfg = get_config(arch).replace(num_layers=layers)
        got, timing = serve_phase(torch, dev, ["--arch", arch,
                                               *SERVE_ARGS[2:]], cfg=cfg)
        B, S = 4, 2048
        d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        C = moe.capacity(cfg, S)
        # products a prefill: q/k/v/o, the router, the experts over their
        # E · B · C capacity slots, the scores (causal) and the last head
        per_layer = (2 * B * S * d * (2 * H + 2 * KV) * hd
                     + 2 * B * S * d * cfg.num_experts
                     + 6 * cfg.num_experts * B * C * d * cfg.d_ff
                     + 4 * B * H * hd * S * (S + 1) // 2)
        flop = layers * per_layer + 2 * B * d * cfg.vocab_size
        weights = tree_gb(cfg)
        print(f"  {arch} ({layers} layers): prefill {flop / 1e12:.1f} TFLOP"
              f" of float32 products, {flop / timing['prefill_ms'] / 1e9:.1f}"
              f" TFLOP/s | decode reads {weights:.1f} GB of weights a step "
              f"(>= {weights / HBM_BYTES_PER_S * 1e12:.1f} ms at 3.35 TB/s)")
        for k_, v in got.items():
            total[k_] = total.get(k_, 0) + v
    return total


def moe_training(torch):
    """17c: qwen3-moe-30b-a3b at full width, its depth and W the first cut
    of MOE_TRAIN_CUTS that reckons under 75 GB, lag-wk and laq@4 through
    ``launch.train`` in phase 5's configuration."""
    from repro_torch.configs import get_config

    want = {"lag-wk": ("delta_sqnorm_blocks", "masked_combine"),
            "laq@4": ("absmax_blocks", "laq_encode_blocks",
                      "masked_combine")}
    arch = MOE_KIND[0]
    (layers, workers), tree = reckon_training_cut(
        get_config(arch), MOE_TRAIN_CUTS, algos=("lag-wk", "laq@4"))
    total = {}
    for algo in ("lag-wk", "laq@4"):
        run = trainer_phase(torch, algo, extra=("--layers", str(layers)),
                            arch=arch, workers=workers)
        for k_ in want[algo]:
            check(run["plane"][k_] >= 4, f"{arch} {algo}: kernel {k_} "
                                         f"launched {run['plane'][k_]} times")
        check(run["peak"] < 80.0, f"{arch} {algo}: peak {run['peak']:.2f} "
                                  f"GB")
        print(f"  {arch} --layers {layers} W={workers} {algo}: peak "
              f"{run['peak']:.2f} GB = {run['peak'] / tree:.2f} trees of "
              f"{tree:.3f} GB")
        for k_, v in run["plane"].items():
            total[k_] = total.get(k_, 0) + v
    return total


def moe_small_agreement(torch, dev):
    """17d: both reduced MoE configs from the same weights on the card and
    on the CPU: the first layer's routing decisions on the same input
    equal, the forward (the kernels on the card) and the loss with its
    load-balance term within rtol 1e-4; then phase 15e's three lag-wk
    rounds."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.models import model, moe

    cfgs = [get_config(a).reduced() for a in MOE_KIND]
    gen = torch.Generator()
    gen.manual_seed(7)
    for cfg in cfgs:
        cpu = model.init(cfg, device="cpu", seed=7)
        gpu = tree_map(lambda t: t.to(dev), cpu)
        b = make_inputs(cfg, TokenStream(cfg.vocab_size, seed=7), 0, 4, 64,
                        device="cpu")
        bg = {n: t.to(dev) for n, t in b.items()}
        with torch.no_grad():
            p0 = {n: t[0] for n, t in cpu["blocks"]["0"]["moe"].items()}
            h = torch.randn((4, 64, cfg.d_model), generator=gen)
            r_cpu = moe.route(p0, moe.groups(h, 2), cfg)
            r_gpu = moe.route(tree_map(lambda t: t.to(dev), p0),
                              moe.groups(h.to(dev), 2), cfg)
            for f in ("experts", "slots", "kept"):
                check(torch.equal(getattr(r_cpu, f),
                                  getattr(r_gpu, f).cpu()),
                      f"small {cfg.arch_id}: routing {f} differs")
            lc, ac = model.forward_with_aux(cpu, cfg, b)
            lg, ag = model.forward_with_aux(gpu, cfg.replace(use_pallas=True),
                                            bg)
            err = max_abs(lg.cpu(), lc)
            check(err <= SERVE_TOL and abs(float(ag) - float(ac))
                  <= 1e-4 * float(ac), f"small {cfg.arch_id}: forward "
                                       f"{err:.3e}, aux {ag} vs {ac}")
            loss_c = float(model.loss_fn(cpu, cfg, b))
            loss_g = float(model.loss_fn(gpu, cfg, bg))
            check(abs(loss_c - loss_g) <= 1e-4 * abs(loss_c),
                  f"small {cfg.arch_id}: loss cpu {loss_c} vs gpu {loss_g}")
        print(f"  small {cfg.arch_id}: routing of layer 0 (2 shards, "
              f"{int((~r_gpu.kept).sum())} of {r_gpu.kept.numel()} "
              f"assignments dropped) equal on card and CPU | logits "
              f"max_abs_err {err:.3e} | aux {float(ag):.6f} / {float(ac):.6f}"
              f" | loss {loss_g:.6f} / {loss_c:.6f}")
        del cpu, gpu
    reduced_agreement(torch, dev, cfgs)


# ---------------------------------------------------------------------------
# Phase 18: bfloat16 serving
# ---------------------------------------------------------------------------

def bf16_ulp(torch, x, dtype=None):
    """One ulp of ``dtype`` (bfloat16 by default: 8 significant bits;
    float16: 11, its subnormals' spacing 2^-24 below 2^-14) at |x|, as
    float32."""
    _, e = torch.frexp(x.float().abs())
    if dtype == torch.float16:
        return torch.ldexp(torch.ones_like(x, dtype=torch.float32),
                           torch.clamp(e, min=-13) - 11)
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def bf16_rms_case(torch, x, sc):
    """A 2-byte (bfloat16 or float16) RMSNorm launch held three ways:
    bitwise to the float32 kernel's y on the widened row (scale 1, an
    aligned copy: both kernels fold by d alone, whatever the offset of x)
    rounded twice as the reference kernel rounds; to the plain version on
    the
    widened row rounded the same way within one ulp at each rounding,
    |scale|·ulp(y) + ulp(out) (the mean's sum order may move y across a
    rounding boundary); to the plain 2-byte version within the reference's
    REF_RMS_TOL.  → (output, max |Δ| against the widened plain version,
    [failures])."""
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rms

    dt = x.dtype
    got = rms.rmsnorm_2d(x, sc)
    ones = torch.ones_like(sc, dtype=torch.float32)
    s32 = sc.float()
    exact = (rms.rmsnorm_2d(x.float(), ones).to(dt).float() * s32).to(dt)
    y = rms_ref.rmsnorm(x.float(), ones)
    want = (y.to(dt).float() * s32).to(dt)
    diff = (got.float() - want.float()).abs()
    bound = s32.abs() * bf16_ulp(torch, y, dt) + bf16_ulp(
        torch, torch.maximum(got.float().abs(), want.float().abs()), dt)
    bad = []
    if not (got.dtype == dt and torch.equal(got, exact)):
        bad.append("not bitwise the float32 kernel's row rounded twice")
    if not bool((diff <= bound).all()):
        bad.append(f"beyond one ulp a rounding of the widened plain "
                   f"version: {float(diff.max()):.3e}")
    plain = rms_ref.rmsnorm(x, sc).float()
    e = max_abs(got.float(), plain)
    if e > REF_RMS_TOL * max(1.0, float(plain.abs().max())):
        bad.append(f"{e:.3e} from the plain bfloat16 version")
    return got, float(diff.max()), bad


def rms_timing(torch, dev, gen, bad, widths=BF16_RMS_WIDTHS,
               dtype=None):
    """18a's RMSNorm at (8192, d) for each d of ``widths`` (22a's at
    float16, ``dtype``): the 2-byte launch held as ``bf16_rms_case``;
    ``rms_readings`` of both dtypes (the float32 rotation starts with the
    widened input), the plain 2-byte version's time and both dtypes' times
    on one reused input.  → {d: the 2-byte row of the kernels line}."""
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rms

    R, out = RMS_FULL[0], {}
    dtype = dtype or torch.bfloat16
    tag = "f16" if dtype == torch.float16 else "bf16"
    for d in widths:
        x = torch.randn((R, d), device=dev, generator=gen).to(dtype)
        sc = torch.randn((d,), device=dev, generator=gen).to(dtype)
        _, e, b = bf16_rms_case(torch, x, sc)
        bad += [f"rmsnorm {tag} full ({R}, {d}): {m}" for m in b]
        xs = rms_rotation(torch, gen, x, sc)
        x32s = rms_rotation(torch, gen, x.float(), sc.float())
        t_b, by = bound_ms(2 * R * d * 2 + d * 2, 4 * R * d)
        t_b32 = bound_ms(2 * R * d * 4 + d * 4, 4 * R * d)[0]
        r16, r32 = rms_readings(torch, xs), rms_readings(torch, x32s)
        lib = lambda t, w: torch.nn.functional.rms_norm(t, (d,), w, 1e-6)
        plain = cuda_ms(torch, lambda: rms_ref.rmsnorm(x, sc), n=20)
        hot = [cuda_ms(torch, lambda: f(*xw), n=50)
               for f in (rms.rmsnorm_2d, lib) for xw in (xs[0], x32s[0])]
        print(rms_reading_line(f"rmsnorm {tag} ({R}, {d})", r16, t_b))
        print(rms_reading_line(f"rmsnorm float32 ({R}, {d})", r32, t_b32))
        print(f"    max |Δ| {e:.3e} against the widened plain version; plain "
              f"{tag} {plain:.4f} ms; rotations of {len(xs)} / {len(x32s)}; "
              f"one reused input: kernel {hot[0]:.4f} / {hot[1]:.4f} ms, "
              f"library {hot[2]:.4f} / {hot[3]:.4f} ms ({tag} / float32)")
        out[d] = dict(max_abs_err=e, ms=r16["kernel"]["device_ms"],
                      plain_ms=plain, bound_ms=t_b, bound_by=by,
                      library_ms=r16["library"]["device_ms"])
        del x, sc, xs, x32s
    return out


def bf16_flash_case(torch, q, k, v, causal=True, window=None):
    """A 2-byte (bfloat16 or float16) flash launch against the plain
    version on the widened inputs rounded to q's dtype (the reference
    kernel's function) within one ulp (+ 1e-6), and against the plain
    2-byte version within the reference's REF_FLASH_TOL.  The widened plain
    version runs its P·V in float64: near an output of 0 the float32 one's
    own sum errs by more than 1e-6 (outputs of about 1e-4 under a window of
    16 keys, sums of terms near 1), where the kernel agrees with float64
    (PERF.md §6).  → (max |Δ|, [failures])."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    dt = q.dtype
    got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = fa_ref.attention(q.double(), k.double(), v.double(),
                            causal=causal, window=window).to(dt)
    plain = fa_ref.attention(q, k, v, causal=causal, window=window)
    S, Skv = q.shape[1], k.shape[1]
    if S > Skv and window is not None:       # rows that see no key
        live = torch.arange(S, device=q.device) - window + 1 < Skv
        got, want, plain = got[:, live], want[:, live], plain[:, live]
    diff = (got.float() - want.float()).abs()
    bound = bf16_ulp(torch, torch.maximum(got.float().abs(),
                                          want.float().abs()), dt) + 1e-6
    bad = []
    if not (got.dtype == dt and bool(torch.isfinite(got).all())
            and bool((diff <= bound).all())):
        bad.append(f"beyond one ulp of the widened plain version: "
                   f"{float(diff.max()):.3e}")
    e = max_abs(got.float(), plain.float())
    if e > REF_FLASH_TOL * max(1.0, float(plain.float().abs().max())):
        bad.append(f"{e:.3e} from the plain {dt} version")
    return float(diff.max()), bad


def bf16_kernel_phase(torch, dev):
    """18a: the bfloat16 instantiations of both kernels on the ragged sets
    and at every registry prefill shape, each shape timed beside the float32
    kernel on the widened inputs, the plain bfloat16 version and the
    library's bfloat16 call; and command-r-35b's (4, 2048, 64/8, 128) in
    float32.  Returns the kernels line's rows for ``rmsnorm_bf16`` and
    ``flash_attention_bf16`` (at llama3.2-1b's shapes)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    F = torch.nn.functional
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    bad, rows, out = [], [], {}

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen).bfloat16()

    for d in BF16_RMS_WIDTHS:
        worst = 0.0
        for r in (1, 7, 129, 1000):
            _, e, b = bf16_rms_case(torch, randn(r, d), randn(d))
            worst = max(worst, e)
            bad += [f"rmsnorm bf16 ({r}, {d}): {m}" for m in b]
        print(f"  rmsnorm bf16 d {d}: rows 1, 7, 129, 1000, max |Δ| "
              f"{worst:.3e} against the widened plain version")
    for hd, H, KV in BF16_RAGGED:
        cases = [(S, S, c, w) for S in FLASH_S for c, w in FLASH_MASKS]
        cases += FLASH_CROSS
        worst = 0.0
        for S, Skv, causal, window in cases:
            e, b = bf16_flash_case(torch, randn(1, S, H, hd),
                                   randn(1, Skv, KV, hd),
                                   randn(1, Skv, KV, hd), causal, window)
            worst = max(worst, e)
            bad += [f"flash bf16 hd {hd} H {H}/{KV} Sq {S} Skv {Skv} "
                    f"causal {causal} window {window}: {m}" for m in b]
        print(f"  flash_attention bf16 hd {hd} H {H}/{KV}: {len(cases)} "
              f"ragged cases, max |Δ| {worst:.3e} against the widened plain "
              f"version")
    for hd, H, KV in PADDED_RAGGED:        # the float32 kernel, zero-padded
        flash_ragged(torch, dev, gen, hd, H, KV, bad)

    out["rmsnorm_bf16"] = rms_timing(torch, dev, gen, bad)[RMS_FULL[1]]

    for B, S, H, KV, hd, causal, window in ATTN_BF16:
        q, k, v = randn(B, S, H, hd), randn(B, S, KV, hd), randn(B, S, KV, hd)
        e, b = bf16_flash_case(torch, q, k, v, causal, window)
        bad += [f"flash bf16 full {(B, S, H, KV, hd)}: {m}" for m in b]
        q32, k32, v32 = q.float(), k.float(), v.float()
        pos = torch.arange(S, device=dev)
        keep = pos[:, None] >= pos[None] if causal else \
            torch.ones((S, S), dtype=torch.bool, device=dev)
        if window is not None:
            keep &= pos[:, None] - pos[None] < window
        # the (query, key) pairs the masks leave, 4·hd FLOP each, at the
        # bfloat16 tensor cores' rate; the design's own work (one bfloat16
        # product for q·kᵀ, three for P·V: twice that) is the second column
        pairs = B * H * int(keep.sum())
        flop = 4 * hd * pairs
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        t_b, by = bound_ms(nbytes, flop, BF16_FLOP_PER_S)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None if window is None else keep
        row = dict(
            what=f"flash_attention bf16 ({B}, {S}, {H}/{KV}, {hd}) "
                 f"{'causal' if causal else 'non-causal'}"
                 + (f" window {window}" if window else ""),
            max_abs_err=e,
            ms=cuda_ms(torch, lambda: fa.flash_attention_fwd(
                q, k, v, causal=causal, window=window), n=10),
            f32_ms=cuda_ms(torch, lambda: fa.flash_attention_fwd(
                q32, k32, v32, causal=causal, window=window), n=10),
            plain_ms=cuda_ms(torch, lambda: fa_ref.attention(
                q, k, v, causal=causal, window=window), n=3),
            bound_ms=t_b, bound_by=by, gflop=flop / 1e9,
            design_bound_ms=bound_ms(nbytes, 2 * flop, BF16_FLOP_PER_S)[0],
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True), n=10))
        rows.append(row)
        if (B, S, H, KV, hd) == ATTN_FULL:
            out["flash_attention_bf16"] = row
        del q, k, v, q32, k32, v32, qt, kt, vt, keep, mask
    for r in rows:
        extra = (f" ({r['gflop']:.1f} GFLOP at the bfloat16 tensor cores' "
                 f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; the design's 1 + 3 "
                 f"bfloat16 products at the same rate "
                 f"{r['design_bound_ms']:.4f} ms)" if "gflop" in r else "")
        print(f"  full-shape {r['what']}: max |Δ| {r['max_abs_err']:.3e} | "
              f"{r['ms']:.4f} ms (float32 kernel {r['f32_ms']:.4f} ms, plain"
              f" {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}{extra} = {r['bound_ms'] / r['ms']:.1%}, "
              f"library {r['library_ms']:.4f} ms, kernel / library "
              f"{r['ms'] / r['library_ms']:.3f})")
    # command-r-35b's heads in float32, never timed before
    print_full_rows([flash_full(torch, dev, gen, ATTN_BF16[4][:5], True,
                                bad)])
    check(not bad, f"bfloat16 kernels: {bad}")
    gc.collect()
    torch.cuda.empty_cache()
    return {k_: {f: r[f] for f in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}
            for k_, r in out.items()}


def bf16_greedy(torch, params, cfg, cache, last, tokens, args, margin):
    """18b: the plain route's greedy tokens from its prefill (``last``, its
    cache ``cache``), teacher-forced on the kernel route's (``tokens``,
    round 0 of the serve run, on the same prompts): equal wherever the
    plain route's top-2 margin exceeds ``margin``."""
    from repro_torch.models import model

    plain = cfg.replace(use_pallas=False)
    sure = same = 0
    logits = last
    with torch.inference_mode():
        for t in range(tokens.shape[1]):
            if t:
                logits, cache = model.decode_step(
                    params, plain, cache, tokens[:, t - 1:t],
                    args.prompt_len + t - 1)
                logits = logits[:, -1]
            top2 = torch.topk(logits.float(), 2, dim=-1).values
            ok = (top2[:, 0] - top2[:, 1]) > margin
            sure += int(ok.sum())
            same += int((logits.argmax(-1) == tokens[:, t])[ok].sum())
    print(f"  greedy: the plain route's tokens (teacher-forced) equal the "
          f"kernel route's at {same} of the {sure} of {tokens.numel()} "
          f"steps whose plain top-2 margin exceeds {margin:.3e}")
    check(same == sure, f"serve {cfg.arch_id}: greedy tokens differ above "
                        f"the margin {margin}")


def reckon_serve_depth(cfg):
    """18b: the most layers of ``cfg`` whose reckoned serving peak (the
    weights + SERVE_ACT_GB) stays under SERVE_RECKON_GB."""
    best = max(n for n in range(1, cfg.num_layers + 1)
               if tree_gb(cfg.replace(num_layers=n)) + SERVE_ACT_GB
               < SERVE_RECKON_GB)
    gb = tree_gb(cfg.replace(num_layers=best))
    print(f"  reckoned {cfg.arch_id} in bfloat16: {best} of "
          f"{cfg.num_layers} layers, {gb:.2f} GB of weights + {SERVE_ACT_GB}"
          f" GB < {SERVE_RECKON_GB} GB ({best + 1}: "
          f"{tree_gb(cfg.replace(num_layers=best + 1)):.2f} GB)")
    return best


def as_bf16(torch, params32, cfg):
    """The float32 tree's weights rounded to bfloat16 but for the leaves
    kept in float32 (``cfg``'s templates say which)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import model
    return tree_map(lambda t, want: t.to(want.dtype), params32,
                    model.templates(cfg))


def bf16_serve(torch, dev):
    """18b: bfloat16 serving through ``launch.serve`` with
    ``get_config(arch, dtype="bfloat16", param_dtype="bfloat16",
    use_pallas=True)``: llama3.2-1b (the main path), command-r-35b at 40
    of 40 layers, qwen3-moe-30b-a3b at 48 of 48, qwen3-moe-235b-a22b at its
    reckoned depth, recurrentgemma-9b at 2 × 4096; where the float32 model
    fits beside it, its weights rounded to bfloat16 and its float32 logits
    on the same prompts."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model

    total = {}
    for arch, argv, layers, f32_fits in SERVE_BF16:
        cfg32 = get_config(arch)
        if layers == "reckon":
            layers = reckon_serve_depth(get_config(arch, **BF16))
        if layers is not None:
            cfg32 = cfg32.replace(num_layers=layers)
        cfg = cfg32.replace(**BF16)
        params = f32_logits = None
        if f32_fits:
            args = serve.build_argparser().parse_args(["--arch", arch,
                                                       *argv])
            gc.collect()
            torch.cuda.empty_cache()
            p32 = model.init(cfg32, device=dev, seed=args.seed)
            prompts = torch.from_numpy(serve.make_prompts(
                cfg.vocab_size, args.batch, args.prompt_len,
                args.seed + 1)).to(dev)
            with torch.inference_mode():
                f32_logits = model.prefill(
                    p32, cfg32, {"tokens": prompts},
                    max_len=args.prompt_len + args.gen)[0].float()
            params = as_bf16(torch, p32, cfg)
            del p32
        got, _ = serve_phase(torch, dev, ["--arch", arch, *argv], cfg=cfg,
                             params=params, f32_logits=f32_logits)
        del params, f32_logits
        for k_, v in got.items():
            total[k_] = total.get(k_, 0) + v
    for k_, v in bf16_hubert_forward(torch, dev).items():
        total[k_] = total.get(k_, 0) + v
    return total


def bf16_hubert_forward(torch, dev):
    """18b: hubert-xlarge's bfloat16 forward at full width and depth (4 ×
    2048 frames; head_dim 80, non-causal, LayerNorm: no RMSNorm), the
    kernel route against the plain route and both against the float32
    model on the widened weights."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.rmsnorm import rmsnorm as rms
    from repro_torch.models import model

    cfg32 = get_config("hubert-xlarge")
    cfg = cfg32.replace(**BF16)
    gc.collect()
    torch.cuda.empty_cache()
    p32 = model.init(cfg32, device=dev, seed=0)
    B, S = HUBERT_FORWARD
    batch = make_inputs(cfg32, TokenStream(cfg.vocab_size), 0, B, S,
                        device=dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ref = model.forward(p32, cfg32, batch).float()
        params = as_bf16(torch, p32, cfg)
        del p32
        out, ms = {}, {}
        for up in (True, False):
            c = cfg.replace(use_pallas=up)
            model.forward(params, c, batch)            # warm-up
            rms.reset_launches()
            fa.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[up] = model.forward(params, c, batch).float()
            torch.cuda.synchronize()
            ms[up] = (time.perf_counter() - t0) * 1e3
            if up:
                launches = {k: v for k, v in {**rms.LAUNCHES,
                                              **fa.LAUNCHES}.items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(out[True]).all()), "hubert bf16: non-finite")
    want = {"flash_attention_bf16": cfg.num_layers}
    check(launches == want, f"hubert bf16 forward launches {launches}")
    err = max_abs(out[True], out[False])
    bound = BF16_ROUTE_FACTOR * BF16_ROUTE_READINGS[cfg.arch_id]["logits"]
    e_k, e_p = max_abs(out[True], ref), max_abs(out[False], ref)
    print(f"  hubert-xlarge bfloat16 forward ({B}, {S}): kernel route "
          f"{ms[True]:.1f} ms, plain route {ms[False]:.1f} ms | logits "
          f"kernel vs plain {err:.3e} (bound {bound:.3e}) | against float32:"
          f" kernel {e_k:.3e}, plain {e_p:.3e} (ratio {e_k / e_p:.3f}) | "
          f"peak {peak:.2f} GB | launches {launches}")
    check(err <= bound, f"hubert bf16 forward differs by {err} > {bound}")
    check(e_k <= BF16_ERR_RATIO * e_p, f"hubert bf16: kernel route's error "
                                       f"{e_k} > {BF16_ERR_RATIO} x {e_p}")
    del params, batch, out, ref
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_bf16": launches["flash_attention_bf16"]}


@contextlib.contextmanager
def remat_on():
    """``launch.train``'s configs with ``remat=True`` (the launcher, like
    the reference's, has no flag for it)."""
    from repro_torch.launch import train
    get = train.get_config
    train.get_config = lambda arch, **kw: get(arch, **kw).replace(
        remat=True)
    try:
        yield
    finally:
        train.get_config = get


def remat_phase(torch, phase5):
    """18c: phase 5's lag-wk (``remat=False``, the port's default) again
    with ``remat=True``: losses and masks bitwise equal; both runs' fwd/bwd
    and peaks."""
    with remat_on():
        on = trainer_phase(torch, "lag-wk")
    run = phase5["lag-wk"]
    for k_, (a, b) in enumerate(zip(run["rounds"], on["rounds"])):
        check(a["loss"] == b["loss"] and a["mask"] == b["mask"],
              f"remat round {k_}: loss {a['loss']!r} / {b['loss']!r}, mask "
              f"{a['mask']} / {b['mask']}")
    print(f"  remat: losses and masks of 4 rounds bitwise equal | fwd/bwd "
          f"{run['summary']['grad_ms']:.1f} ms (remat=False) / "
          f"{on['summary']['grad_ms']:.1f} ms (remat=True) | peak "
          f"{run['peak']:.2f} / {on['peak']:.2f} GB")
    return on["plane"]


def bf16_small_agreement(torch, dev):
    """18d: every reduced config at bfloat16 from the same weights: the
    forward and the prefill's last logits on the card (the kernels) and on
    the CPU (their plain versions), each against the float32 model on the
    widened weights on the CPU: the card's error within BF16_ERR_RATIO ×
    the CPU's."""
    from repro_torch.configs import ALL_ARCHS, get_config
    from repro_torch.core.tree import tree_map
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.models import model

    worst = 0.0
    for arch in ALL_ARCHS:
        cfg = get_config(arch).reduced(**BF16)
        if arch == "recurrentgemma-9b":
            cfg = cfg.replace(num_layers=8)
        cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
        cpu = model.init(cfg, device="cpu", seed=9)
        gpu = tree_map(lambda t: t.to(dev), cpu)
        p32 = tree_map(lambda t: t.float(), cpu)
        b = make_inputs(cfg32, TokenStream(cfg.vocab_size, seed=9), 0, 2, 64,
                        device="cpu")
        bg = {n: t.to(dev) for n, t in b.items()}
        with torch.inference_mode():
            runs = [(model.forward(gpu, cfg.replace(use_pallas=True), bg)
                     .cpu(), model.forward(cpu, cfg, b),
                     model.forward(p32, cfg32, b))]
            if cfg.family != "audio":
                pre = lambda p, c, x: model.prefill(
                    p, c, {"tokens": x["tokens"]}, max_len=80)[0]
                runs.append((pre(gpu, cfg.replace(use_pallas=True), bg)
                             .cpu(), pre(cpu, cfg, b), pre(p32, cfg32, b)))
        line = []
        for card, host, ref in runs:
            e_c, e_h = max_abs(card.float(), ref), max_abs(host.float(), ref)
            check(bool(torch.isfinite(card).all()) and card.dtype ==
                  torch.bfloat16 and e_c <= BF16_ERR_RATIO * e_h,
                  f"small {arch} bf16: card {e_c} vs CPU {e_h}")
            worst = max(worst, e_c / e_h)
            line.append(f"{e_c:.3e} / {e_h:.3e}")
        print(f"  small {arch} bfloat16, card (kernels) / CPU (plain) against"
              f" float32: forward {line[0]}"
              + (f", prefill {line[1]}" if len(line) > 1 else ""))
        del cpu, gpu, p32
    print(f"  small bfloat16: the card's error at most {worst:.3f} x the "
          f"CPU's (bound {BF16_ERR_RATIO})")


# ---------------------------------------------------------------------------
# Phase 19: bfloat16 training on the comm plane, the one-card dry-run
# ---------------------------------------------------------------------------

def bf16_plane_kernel_phase(torch, dev, half_dtype=None,
                            combos=BF16_COMBOS, tag="19a"):
    """19a (22a for ``half_dtype`` float16): kernels 1-4's 2-byte
    instantiations at llama3.2-1b's full-width W = 2 buffers (2.47e9 elements an operand):
    bitwise their plain versions (sums within SUM_RTOL, as phase 4), and
    bitwise the float32 kernel on the widened operands (partials and sums
    too: the same element-to-lane map and order); ms, plain ms, byte bound
    and library call.  In float16 the operands reach its subnormals and
    ±65504 (``f16_edges``).  → the kernels line's rows of these
    instantiations."""
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import param_layout
    from repro_torch.fastpath import kernels, kernels_ref
    from repro_torch.fastpath.plan import FastPathPlan

    lo = param_layout(get_config("llama3.2-1b"))
    W, R = 2, lo.rows
    N, S = W * R * 128, W * R // 8
    step_rows = 1 << 19
    f32, bf = torch.float32, half_dtype or torch.bfloat16
    gen = torch.Generator(device=dev)
    gen.manual_seed(1919)
    mask = torch.tensor([True, False], device=dev)
    m3 = mask.to(f32).view(W, 1, 1)
    plan = FastPathPlan("auto")
    rows = {}

    def rand(dtype, scale=1.0):
        x = torch.randn((W, R, 128), device=dev, generator=gen, dtype=f32)
        x = x.mul_(scale) if scale != 1.0 else x
        return (f16_edges(x) if bf == torch.float16 else x).to(dtype)

    def wide(x, r0, r1):
        """Rows r0:r1 widened to float32, contiguous (a kernel operand)."""
        return x[:, r0:r1].float().contiguous()

    def chunks():
        for r0 in range(0, R, step_rows):
            r1 = min(r0 + step_rows, R)
            yield r0, r1, slice(r0 // 8, r1 // 8)

    def plain_ms(fn):
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for r0, r1, _ in chunks():
            fn(r0, r1)
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1)

    for combo, sfx in combos.items():
        da = f32 if combo.startswith("f32") else bf
        a, b, e = rand(da), rand(bf, 0.5), rand(f32, 0.01)
        isz = a.element_size() + b.element_size()
        out = {}
        # -- delta_sqnorm_blocks ----------------------------------------
        got = kernels.delta_sqnorm_blocks(a, b)
        err = 0.0
        for r0, r1, sr in chunks():
            w32 = kernels.delta_sqnorm_blocks(wide(a, r0, r1),
                                              wide(b, r0, r1))
            check(bitwise(torch, got[:, sr], w32),
                  f"{combo} delta_sqnorm_blocks: not the float32 kernel's "
                  f"on the widened operands")
            want = kernels_ref.delta_sqnorm_blocks(a[:, r0:r1], b[:, r0:r1])
            torch.testing.assert_close(got[:, sr], want, rtol=SUM_RTOL,
                                       atol=0)
            err = max(err, max_abs(got[:, sr], want))
        t_b, by = bound_ms(N * isz + S * 4, 3 * N)
        out["delta_sqnorm_blocks"] = dict(
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: kernels.delta_sqnorm_blocks(a, b)),
            plain_ms=plain_ms(lambda r0, r1: kernels_ref.delta_sqnorm_blocks(
                a[:, r0:r1], b[:, r0:r1])),
            bound_ms=t_b, bound_by=by, library_ms=None)
        del got
        # -- absmax_blocks ----------------------------------------------
        parts = kernels.absmax_blocks(a, b, e)
        for r0, r1, sr in chunks():
            check(bitwise(torch, parts[:, sr], kernels_ref.absmax_blocks(
                a[:, r0:r1], b[:, r0:r1], e[:, r0:r1])) and bitwise(
                torch, parts[:, sr], kernels.absmax_blocks(
                    wide(a, r0, r1), wide(b, r0, r1),
                    wide(e, r0, r1))),
                f"{combo} absmax_blocks not bitwise")
        t_b, by = bound_ms(N * (isz + 4) + S * 4, 4 * N)
        out["absmax_blocks"] = dict(
            max_abs_err=0.0,
            ms=cuda_ms(torch, lambda: kernels.absmax_blocks(a, b, e)),
            plain_ms=plain_ms(lambda r0, r1: kernels_ref.absmax_blocks(
                a[:, r0:r1], b[:, r0:r1], e[:, r0:r1])),
            bound_ms=t_b, bound_by=by, library_ms=None)
        # -- laq_encode_blocks (bits 4) ---------------------------------
        steps = plan._per_leaf(parts, lo, "max")
        steps = steps / torch.full_like(steps, 7.0)
        subs = steps[:, plan.sub_leaf(lo, dev)].contiguous()
        del parts
        p, r, sq = kernels.laq_encode_blocks(a, b, e, subs, 4)
        err = 0.0
        for r0, r1, sr in chunks():
            wp, wr, wsq = kernels_ref.laq_encode_blocks(
                a[:, r0:r1], b[:, r0:r1], e[:, r0:r1], subs[:, sr], 4)
            check(bitwise(torch, p[:, r0:r1], wp)
                  and bitwise(torch, r[:, r0:r1], wr),
                  f"{combo} laq_encode_blocks: payload/residual not bitwise")
            torch.testing.assert_close(sq[:, sr], wsq, rtol=SUM_RTOL, atol=0)
            err = max(err, max_abs(sq[:, sr], wsq))
            xp, xr, xsq = kernels.laq_encode_blocks(
                wide(a, r0, r1), wide(b, r0, r1),
                wide(e, r0, r1), subs[:, sr], 4)
            check(bitwise(torch, p[:, r0:r1], xp)
                  and bitwise(torch, r[:, r0:r1], xr)
                  and bitwise(torch, sq[:, sr], xsq),
                  f"{combo} laq_encode_blocks: not the float32 kernel's")
            del wp, wr, wsq, xp, xr, xsq
        t_b, by = bound_ms(N * (isz + 4 + 8) + 2 * S * 4, 10 * N)
        out["laq_encode_blocks"] = dict(
            max_abs_err=err,
            ms=cuda_ms(torch, lambda: kernels.laq_encode_blocks(
                a, b, e, subs, 4, payload_out=p), n=3),
            plain_ms=plain_ms(lambda r0, r1: kernels_ref.laq_encode_blocks(
                a[:, r0:r1], b[:, r0:r1], e[:, r0:r1],
                subs[:, slice(r0 // 8, r1 // 8)], 4)),
            bound_ms=t_b, bound_by=by, library_ms=None)
        del p, r, sq, subs, steps
        # -- masked_combine (add: the ĝ fold into b's dtype) -------------
        for mode in ("add", "select"):
            got = kernels.masked_combine(a, b, mask, mode)
            for r0, r1, _ in chunks():
                check(bitwise(torch, got[:, r0:r1], kernels_ref.masked_combine(
                    a[:, r0:r1], b[:, r0:r1], mask, mode)) and bitwise(
                    torch, got[:, r0:r1], kernels.masked_combine(
                        wide(a, r0, r1), wide(b, r0, r1), mask,
                        mode).to(bf)),
                    f"{combo} masked_combine {mode} not bitwise")
            del got
        t_b, by = bound_ms(N * (isz + 2) + W * 4, 2 * N)
        out["masked_combine"] = dict(
            max_abs_err=0.0,
            ms=cuda_ms(torch, lambda: kernels.masked_combine(a, b, mask,
                                                             "add")),
            plain_ms=plain_ms(lambda r0, r1: kernels_ref.masked_combine(
                a[:, r0:r1], b[:, r0:r1], mask, "add")),
            bound_ms=t_b, bound_by=by,
            library_ms=cuda_ms(torch, lambda: torch.addcmul(b, a, m3))
            if a.dtype == b.dtype else None)
        for k, v in out.items():
            print(f"  {tag} {k}[{combo}]: max_abs_err {v['max_abs_err']:.3e} "
                  f"| {v['ms']:.3f} ms (plain {v['plain_ms']:.3f} ms, bound "
                  f"{v['bound_ms']:.3f} ms by {v['bound_by']}, library "
                  f"{v['library_ms']}) | bound / kernel "
                  f"{v['bound_ms'] / v['ms']:.1%}")
        rows.update({k + sfx: v for k, v in out.items()})
        del a, b, e
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def bf16_train_run(torch, cfg, tcfg, plain=False, steps=4, workers=2):
    """``steps`` rounds of ``make_train_step(cfg, tcfg)`` on the card (W =
    ``workers``, batch 4, seq 256, weights from seed 0), on the plane or, with
    ``plain``, the plain route (``make_policy(fastpath=None)``): losses,
    masks, ms a round with the device's fwd/bwd and comm ms, the peak and
    the launches of the plane's kernels (float32 and bfloat16
    instantiations)."""
    from repro_torch import comm
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.dist import lag_trainer as lt
    from repro_torch.fastpath import kernels

    policy = comm.make_policy(tcfg.algo, bits=tcfg.laq_bits,
                              fastpath=None) if plain else None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    state = lt.init_state(cfg, tcfg, device="cuda", seed=0, policy=policy)
    step = lt.make_train_step(cfg, tcfg, policy=policy)
    stream = TokenStream(cfg.vocab_size)
    rounds = []
    for k in range(steps):
        batch = make_inputs(cfg, stream, k, 4, 256, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rounds.append(dict(loss=float(m["loss"]),
                           mask=m["comm_mask"].to(torch.int32).tolist(),
                           ms=(time.perf_counter() - t0) * 1e3,
                           **lt.phase_ms(m)))
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(kernels.LAUNCHES)
    check(all(math.isfinite(r["loss"]) for r in rounds),
          f"{cfg.arch_id} {tcfg.algo}: non-finite loss")
    check(bool(torch.isfinite(state["theta"]).all()),
          f"{cfg.arch_id} {tcfg.algo}: non-finite parameters")
    check(state["theta"].dtype == cfg.params_dtype
          and state["lag"]["grad_hat"].dtype == (
              getattr(torch, tcfg.grad_hat_dtype) if tcfg.grad_hat_dtype
              else cfg.params_dtype), "state dtypes")
    check(all(rounds[0]["mask"]) and len(rounds[0]["mask"]) == workers,
          "round 0 must upload all")
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    steady = rounds[1:]
    mean = {k: sum(r[k] for r in steady) / len(steady)
            for k in ("ms", "grad_ms", "comm_ms")}
    return dict(rounds=rounds, peak=peak, launches=launches, mean=mean)


def run_line(label, run, steps=4):
    mean = run["mean"]
    used = {k: v for k, v in run["launches"].items() if v}
    return (f"  {label}: losses {[round(r['loss'], 6) for r in run['rounds']]}"
            f" | masks {[r['mask'] for r in run['rounds']]} | rounds 1-"
            f"{steps - 1} mean {mean['ms']:.1f} ms (device: fwd/bwd "
            f"{mean['grad_ms']:.1f} ms, comm plane + server "
            f"{mean['comm_ms']:.1f} ms) | peak {run['peak']:.2f} GB | "
            f"launches a round "
            f"{ {k: v / steps for k, v in used.items()} }")


def reckoned_peak_gb(cfg, tcfg, route="plane"):
    """The dry-run's reckoned peak of one training step at ``tcfg``'s W,
    batch 4, seq 256 (``repro_torch.launch.dryrun``, on the meta device),
    on ``route``: "plane", "legacy" or "plain" (as ``mixed_route_run``)."""
    from repro_torch import comm
    from repro_torch.launch import dryrun
    if route == "legacy":
        tcfg = tcfg.replace(use_pallas_comm=True)
    policy = comm.make_policy(tcfg.algo, bits=tcfg.laq_bits,
                              fastpath=None) if route == "plain" else None
    rec = dryrun.reckon(cfg, "train_4k", tcfg.num_workers, batch=4,
                        seq=256, tcfg=tcfg, policy=policy)
    return rec["memory"]["peak_bytes"] / 1e9


def bf16_training_phase(torch, phase5_runs):
    """19b-19d: bfloat16 training through ``init_state`` /
    ``make_train_step`` (the launcher has no dtype flag, as the
    reference's has none): 19b llama3.2-1b at bfloat16 (lag-wk, laq@4) and
    the float32 model with ``grad_hat_dtype="bfloat16"`` (lag-wk), each
    on the plane and on the card's plain route; 19c command-r-35b at full
    width and the depth the dry-run reckons under BF16_TRAIN_RECKON_GB;
    19d each reckoned peak beside the measured one.  → the plane's
    launches of these runs, and 19b's plane masks by label (20c's
    reference)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import TrainerConfig
    from repro_torch.launch import dryrun

    total, peaks, masks19, runs19 = {}, [], {}, {}
    for arch, ckw, tkw in BF16_TRAIN:
        cfg = get_config(arch, **ckw)
        tcfg = TrainerConfig(num_workers=2, lr=0.3, **tkw)
        plane = bf16_train_run(torch, cfg, tcfg)
        plain = bf16_train_run(torch, cfg, tcfg, plain=True)
        label = f"{arch} {'bfloat16' if ckw else 'float32'} {tkw['algo']}" \
            + (" grad_hat_dtype=bfloat16" if "grad_hat_dtype" in tkw else "")
        print(run_line(label + " plane", plane))
        print(run_line(label + " plain route", plain))
        masks = masks19[label] = [r["mask"] for r in plane["rounds"]]
        runs19[label] = plane["rounds"]
        check(masks == [r["mask"] for r in plain["rounds"]],
              f"{label}: plane and plain route masks differ")
        dl = max(abs(a["loss"] - b["loss"]) for a, b in
                 zip(plane["rounds"], plain["rounds"]))
        bound = BF16_ROUTE_FACTOR * BF16_ROUTE_LOSS_READINGS[" ".join(
            [tkw["algo"]] + [f"{k}={v}" for k, v in tkw.items()
                             if k != "algo"])]
        print(f"  {label}: plane vs plain route max |Δ loss| {dl:.3e} "
              f"(bound {bound:.3e}), masks equal")
        check(dl <= bound, f"{label}: |Δ loss| {dl}")
        bf16_k = [k for k, v in plane["launches"].items()
                  if k.endswith(("_bb", "_fb")) and v]
        check(bf16_k, f"{label}: no bfloat16 instantiation launched")
        for k, v in plane["launches"].items():
            total[k] = total.get(k, 0) + v
        peaks.append((label, plane["peak"], reckoned_peak_gb(cfg, tcfg)))

    # 19c: command-r-35b, all-bfloat16 dense, at the reckoned depth: W = 2
    # first, W = 1 when no depth of W = 2 reckons under the budget
    cfg = get_config("command-r-35b", **BF16)
    for workers in (2, 1):
        tcfg = TrainerConfig(algo="lag-wk", num_workers=workers, lr=0.3)
        t0 = time.perf_counter()
        layers = dryrun.max_layers(cfg, "train_4k", workers,
                                   budget=BF16_TRAIN_RECKON_GB * 1e9,
                                   batch=4, seq=256, tcfg=tcfg)
        print(f"  19c dry-run: command-r-35b bfloat16 W={workers} batch 4 "
              f"seq 256: {layers} of {cfg.num_layers} layers reckon under "
              f"{BF16_TRAIN_RECKON_GB} GB ({time.perf_counter() - t0:.1f} s)")
        if layers:
            break
    check(layers > 0, "command-r-35b: no depth reckons under the budget")
    cut = cfg.replace(num_layers=layers)
    label = f"command-r-35b bfloat16 lag-wk --layers {layers} W={workers}"
    run = bf16_train_run(torch, cut, tcfg, workers=workers)
    print(run_line(label, run))
    check(run["peak"] < 80.0, f"command-r-35b: peak {run['peak']:.2f} GB")
    for k, v in run["launches"].items():
        total[k] = total.get(k, 0) + v
    peaks.append((label, run["peak"], reckoned_peak_gb(cut, tcfg)))

    # 19d: phase 5's float32 runs beside their reckonings too
    cfg32 = get_config("llama3.2-1b")
    for algo in ("lag-wk", "laq@4"):
        peaks.append((f"phase 5 llama3.2-1b float32 {algo}",
                      phase5_runs[algo]["peak"], reckoned_peak_gb(
                          cfg32, TrainerConfig(algo=algo, num_workers=2,
                                               lr=0.3))))
    lo, hi = PEAK_RATIO_BAND
    for label, measured, reckoned in peaks:
        ratio = measured / reckoned
        print(f"  19d {label}: reckoned {reckoned:.2f} GB, measured "
              f"(max_memory_allocated) {measured:.2f} GB, ratio {ratio:.4f} "
              f"(band {lo}-{hi})")
        check(lo <= ratio <= hi, f"{label}: measured / reckoned peak "
                                 f"{ratio:.4f} outside {PEAK_RATIO_BAND}")
    return total, masks19, runs19


# ---------------------------------------------------------------------------
# Phase 20: bfloat16 training of the mixed trees, and the legacy route at
# bfloat16
# ---------------------------------------------------------------------------

def legacy_bf16_kernel_phase(torch, dev, half_dtype=None,
                             combos=LEGACY_COMBOS, tag="20a"):
    """20a (22a for ``half_dtype`` float16): the legacy kernels' 2-byte
    instantiations at llama3.2-1b's 11 full-width leaves, W = 2 (one
    round's 22 launches of each): bitwise their plain versions (sums within
    SUM_RTOL) and bitwise the float32 kernel on the operands widened to
    float32 (sums too: the same element-to-thread map and fold order); ms,
    plain ms, byte bound and library call.  In float16 the operands reach
    its subnormals and ±65504 (``f16_edges``).  → the kernels line's rows
    of these instantiations."""
    from repro_torch.configs import get_config
    from repro_torch.core.tree import tree_leaves
    from repro_torch.dist.lag_trainer import param_layout
    from repro_torch.kernels.lag_trigger import lag_trigger as lt
    from repro_torch.kernels.lag_trigger import ref

    f32, bf = torch.float32, half_dtype or torch.bfloat16
    one = "_f16" if bf == torch.float16 else "_bf16"
    lo = param_layout(get_config("llama3.2-1b"))
    W = 2
    gen = torch.Generator(device=dev)
    gen.manual_seed(2020)
    pairs = [(i, m) for m in range(W) for i in range(lo.num_leaves)]
    n_el = W * sum(lo.sizes)
    half = torch.tensor(0.5, device=dev)
    rows = {}

    def leaves(dtype, scale):
        x = torch.randn((W, lo.rows, 128), device=dev, generator=gen)
        x = x.mul_(scale) if scale != 1.0 else x
        x = (f16_edges(x) if bf == torch.float16 else x).to(dtype)
        return tree_leaves(lo.unflatten_stacked(x, like=dtype))

    def each(fn):
        def go():
            for i, m in pairs:
                fn(i, m)
        return go

    for combo, sfx in combos.items():
        da = f32 if combo.startswith("f32") else bf
        A, B, C = leaves(da, 1.0), leaves(bf, 0.5), leaves(f32, 0.01)
        errs = {}

        def close(name, got, want):
            torch.testing.assert_close(got, want, rtol=SUM_RTOL, atol=0)
            errs[name] = max(errs.get(name, 0.0), max_abs(got, want))

        for i in range(lo.num_leaves):
            a, b, c = A[i][0], B[i][0], C[i][0]
            wa, wb = a.float(), b.float()
            what = f"{combo} leaf {tuple(a.shape)}"
            got = lt.delta_sqnorm_2d(a, b)
            close("delta_sqnorm_2d", got, ref.delta_sqnorm(a, b))
            check(bitwise(torch, got, lt.delta_sqnorm_2d(wa, wb)),
                  f"delta_sqnorm_2d {what}: not the float32 kernel's")
            if da == bf:
                got = lt.sqnorm_2d(a)
                close("sqnorm_2d", got, ref.sqnorm(a))
                check(bitwise(torch, got, lt.sqnorm_2d(wa)),
                      f"sqnorm_2d {what}: not the float32 kernel's")
            got = lt.masked_update_2d(a, b, half)
            check(bitwise(torch, got, ref.masked_lazy_update(a, b, half))
                  and bitwise(torch, got, lt.masked_update_2d(
                      wa, wb, half).to(bf)),
                  f"masked_update_2d {what} not bitwise")
            scale = lt.innovation_absmax_2d(a, b, c)
            check(bitwise(torch, scale, ref.innovation_absmax(a, b, c))
                  and bitwise(torch, scale, lt.innovation_absmax_2d(
                      wa, wb, c)), f"innovation_absmax_2d {what} not bitwise")
            p, r, sq = lt.laq_encode_2d(a, b, c, scale, 4)
            wp, wr, wsq = ref.laq_encode(a, b, c, scale, 4)
            check(bitwise(torch, p, wp) and bitwise(torch, r, wr),
                  f"laq_encode_2d {what}: payload/residual not bitwise")
            close("laq_encode_2d", sq, wsq)
            xp, xr, xsq = lt.laq_encode_2d(wa, wb, c, scale, 4)
            check(bitwise(torch, p, xp) and bitwise(torch, r, xr)
                  and bitwise(torch, sq, xsq),
                  f"laq_encode_2d {what}: not the float32 kernel's")
            del wa, wb, p, r, wp, wr, xp, xr
        sa = A[0].element_size()
        kern = {
            "delta_sqnorm_2d": lambda i, m: lt.delta_sqnorm_2d(A[i][m],
                                                               B[i][m]),
            "masked_update_2d": lambda i, m: lt.masked_update_2d(
                A[i][m], B[i][m], half),
            "innovation_absmax_2d": lambda i, m: lt.innovation_absmax_2d(
                A[i][m], B[i][m], C[i][m]),
            "laq_encode_2d": lambda i, m: lt.laq_encode_2d(
                A[i][m], B[i][m], C[i][m], half, 4),
        }
        plain = {
            "delta_sqnorm_2d": lambda i, m: ref.delta_sqnorm(A[i][m],
                                                             B[i][m]),
            "masked_update_2d": lambda i, m: ref.masked_lazy_update(
                A[i][m], B[i][m], half),
            "innovation_absmax_2d": lambda i, m: ref.innovation_absmax(
                A[i][m], B[i][m], C[i][m]),
            "laq_encode_2d": lambda i, m: ref.laq_encode(
                A[i][m], B[i][m], C[i][m], half, 4),
        }
        hb = half.to(bf)
        library = {}
        if da == bf:       # one PyTorch call at one dtype
            library = {
                "delta_sqnorm_2d": lambda i, m: torch.dist(A[i][m], B[i][m]),
                "masked_update_2d": lambda i, m: torch.lerp(B[i][m], A[i][m],
                                                            hb)}
            kern["sqnorm_2d"] = lambda i, m: lt.sqnorm_2d(A[i][m])
            plain["sqnorm_2d"] = lambda i, m: ref.sqnorm(A[i][m])
            library["sqnorm_2d"] = lambda i, m: torch.dot(
                A[i][m].view(-1), A[i][m].view(-1))
        # bytes: each input read once, each output written once
        work = {"delta_sqnorm_2d": ((sa + 2) * n_el, 3 * n_el),
                "sqnorm_2d": (2 * n_el, 2 * n_el),
                "masked_update_2d": ((sa + 4) * n_el, 3 * n_el),
                "innovation_absmax_2d": ((sa + 6) * n_el, 4 * n_el),
                "laq_encode_2d": ((sa + 14) * n_el, 10 * n_el)}
        for k, fn in kern.items():
            nbytes, nops = work[k]
            t_b, by = bound_ms(nbytes + len(pairs) * 4, nops)
            lib = library.get(k)
            name = k + (one if k == "sqnorm_2d" else sfx)
            r = rows[name] = dict(
                max_abs_err=errs.get(k, 0.0), ms=cuda_ms(torch, each(fn),
                                                         n=3),
                plain_ms=cuda_ms(torch, each(plain[k]), n=2),
                bound_ms=t_b, bound_by=by,
                library_ms=None if lib is None else cuda_ms(
                    torch, each(lib), n=3))
            print(f"  {tag} {name}: max_abs_err {r['max_abs_err']:.3e} | "
                  f"round ({len(pairs)} launches) {r['ms']:.3f} ms (plain "
                  f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by "
                  f"{r['bound_by']}, library {r['library_ms']}) | bound / "
                  f"kernel {r['bound_ms'] / r['ms']:.1%}")
        del A, B, C
        gc.collect()
        torch.cuda.empty_cache()
    print(f"  {lo.num_leaves} full-width leaves, combinations "
          f"{list(combos)}: masked update, absmax, LAQ payload and "
          f"residual bitwise the plain versions, sums within rtol "
          f"{SUM_RTOL}; every output bitwise the float32 kernel's on the "
          f"widened operands")
    return rows


def mixed_route_run(torch, cfg, tcfg, route, steps, workers):
    """``steps`` rounds of ``make_train_step(cfg, tcfg)`` on the card (W =
    ``workers``, batch 4, seq 256, weights from seed 0) on ``route``:
    "plane", "legacy" (``use_pallas_comm=True``) or "plain"
    (``make_policy(fastpath=None)``): losses, masks, ms a round with the
    device's fwd/bwd and comm ms, the peak and the launches of the plane's
    and of the legacy route's instantiations."""
    from repro_torch import comm
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.dist import lag_trainer as lt
    from repro_torch.fastpath import kernels
    from repro_torch.kernels.lag_trigger import lag_trigger as legacy

    if route == "legacy":
        tcfg = tcfg.replace(use_pallas_comm=True)
    policy = comm.make_policy(tcfg.algo, bits=tcfg.laq_bits,
                              fastpath=None) if route == "plain" else None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    legacy.reset_launches()
    state = lt.init_state(cfg, tcfg, device="cuda", seed=0, policy=policy)
    step = lt.make_train_step(cfg, tcfg, policy=policy)
    stream = TokenStream(cfg.vocab_size)
    rounds = []
    for k in range(steps):
        batch = make_inputs(cfg, stream, k, 4, 256, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        rounds.append(dict(loss=float(m["loss"]),
                           mask=m["comm_mask"].to(torch.int32).tolist(),
                           ms=(time.perf_counter() - t0) * 1e3,
                           **lt.phase_ms(m)))
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {**kernels.LAUNCHES, **legacy.LAUNCHES}
    theta = state["theta"]
    check(all(math.isfinite(r["loss"]) for r in rounds),
          f"{cfg.arch_id} {tcfg.algo} {route}: non-finite loss")
    parts = tuple(theta) if isinstance(theta, tuple) else (theta,)
    check(all(bool(torch.isfinite(t).all()) for t in parts),
          f"{cfg.arch_id} {tcfg.algo} {route}: non-finite parameters")
    check(all(rounds[0]["mask"]) and len(rounds[0]["mask"]) == workers,
          "round 0 must upload all")
    dtypes = [t.dtype for t in parts]
    del state, step, theta, parts
    gc.collect()
    torch.cuda.empty_cache()
    steady = rounds[1:]
    mean = {k: sum(r[k] for r in steady) / len(steady)
            for k in ("ms", "grad_ms", "comm_ms")}
    return dict(rounds=rounds, peak=peak, launches=launches, mean=mean,
                dtypes=dtypes)


def mixed_training_phase(torch):
    """20b: each tree that keeps float32 leaves at bfloat16, full width,
    lag-wk and laq@4 on the plane, the legacy route and the plain route;
    → the launches of these runs."""
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import TrainerConfig, param_layout
    from repro_torch.launch import dryrun

    total, peaks = {}, []
    for arch, fixed in MIXED_TRAIN:
        cfg = get_config(arch, **BF16)
        for algo in ("lag-wk", "laq@4"):
            budget = MIXED_RECKON_GB / (
                MIXED_LAQ_ROUTE_RATIO if algo == "laq@4" else 1.0)
            if fixed is None:
                t0 = time.perf_counter()
                for workers in (2, 1):
                    layers = dryrun.max_layers(
                        cfg, "train_4k", workers,
                        budget=budget * 1e9, batch=4, seq=256,
                        tcfg=TrainerConfig(algo=algo, num_workers=workers,
                                           lr=0.3))
                    if layers:
                        break
                print(f"  20b dry-run: {arch} bfloat16 {algo} W={workers}: "
                      f"{layers} of {cfg.num_layers} layers reckon the "
                      f"plane under {budget:.2f} GB "
                      f"({time.perf_counter() - t0:.1f} s)")
            else:
                layers, workers = fixed
            check(layers > 0, f"{arch} {algo}: no depth reckons under the "
                              f"budget")
            tcfg = TrainerConfig(algo=algo, num_workers=workers, lr=0.3)
            cut = cfg.replace(num_layers=layers)
            # the plain route holds the legacy route's trees (its plain
            # versions' outputs are the kernels'): one reckoning serves both
            # (equal to the byte in every case reckoned apart, H100 80GB
            # HBM3, 700 W).  A route whose reckoned peak is not under the
            # budget is not run (laq@4's legacy and plain routes hold
            # float32 trees that the plane folds in place); the plane is
            reckoned = {r: reckoned_peak_gb(cut, tcfg, r)
                        for r in ("plane", "legacy")}
            reckoned["plain"] = reckoned["legacy"]
            routes = [r for r in ROUTES if reckoned[r] < MIXED_RECKON_GB]
            print(f"  20b dry-run: {arch} {algo} --layers {layers} "
                  f"W={workers}: reckoned peaks "
                  f"{ {r: round(v, 2) for r, v in reckoned.items()} } GB; "
                  f"routes run: {routes}")
            if fixed == (1, 1) and "plane" not in routes:
                print(f"  20b {arch} {algo} --layers 1 W=1: not under "
                      f"{MIXED_RECKON_GB} GB: not run")
                continue
            check("plane" in routes, f"{arch} {algo}: reckoned {reckoned}")
            lo = param_layout(cut)
            n_b, n_f = (p.num_leaves for p in lo.parts)
            print(f"  {arch} --layers {layers} W={workers}: {n_b} bfloat16 "
                  f"leaves in {lo.parts[0].rows} rows, {n_f} float32 leaves "
                  f"in {lo.parts[1].rows} rows; bfloat16 tree "
                  f"{tree_gb(cut):.3f} GB")
            runs = {r: mixed_route_run(torch, cut, tcfg, r, MIXED_STEPS,
                                       workers) for r in routes}
            label = f"{arch} bfloat16 {algo} --layers {layers} W={workers}"
            for r, run in runs.items():
                check(run["dtypes"] == [torch.bfloat16, torch.float32],
                      f"{label} {r}: θ parts {run['dtypes']}")
                print(run_line(f"20b {label} {r}", run, MIXED_STEPS))
                for k, v in run["launches"].items():
                    total[k] = total.get(k, 0) + v
            # each route against the plain route, or the plane where the
            # plain route does not fit (the legacy route is the plain
            # route's arithmetic)
            base = "plain" if "plain" in runs else "plane"
            masks = [r["mask"] for r in runs[base]["rounds"]]
            for r in runs:
                if r == base:
                    continue
                check([x["mask"] for x in runs[r]["rounds"]] == masks,
                      f"{label}: {r} and {base} route masks differ")
                dl = max(abs(a["loss"] - b["loss"]) for a, b in
                         zip(runs[r]["rounds"], runs[base]["rounds"]))
                bound = BF16_ROUTE_FACTOR \
                    * MIXED_ROUTE_LOSS_READINGS[f"{algo} {r}"]
                print(f"  20b {label}: {r} vs {base} route max |Δ loss| "
                      f"{dl:.3e} (bound {bound}), masks equal")
                check(dl <= bound, f"{label} {r}: |Δ loss| {dl}")
            # the launches a round by instantiation
            pl = runs["plane"]["launches"]
            want_plane = {"lag-wk": {"delta_sqnorm_blocks_bb": 1,
                                     "delta_sqnorm_blocks": 1,
                                     "masked_combine_bb": 1,
                                     "masked_combine": 1},
                          "laq@4": {"absmax_blocks_bb": 1,
                                    "absmax_blocks": 1,
                                    "laq_encode_blocks_bb": 1,
                                    "laq_encode_blocks": 1,
                                    "masked_combine_fb": 1,
                                    "masked_combine": 3}}[algo]
            got_plane = {k: v / MIXED_STEPS for k, v in pl.items() if v}
            check(got_plane == want_plane, f"{label}: the plane launched "
                  f"{got_plane} a round, want {want_plane}")
            want_legacy = {"lag-wk": {"sqnorm_2d_bf16": n_b * workers,
                                      "sqnorm_2d": n_f * workers},
                           "laq@4": {"innovation_absmax_2d_bb": n_b * workers,
                                     "laq_encode_2d_bb": n_b * workers,
                                     "innovation_absmax_2d": n_f * workers,
                                     "laq_encode_2d": n_f * workers}}[algo]
            got_legacy = {k: v / MIXED_STEPS for k, v in runs[
                "legacy"]["launches"].items() if v} if "legacy" in runs \
                else None
            check(got_legacy in (None, want_legacy), f"{label}: the legacy "
                  f"route launched {got_legacy} a round, want {want_legacy}")
            check("plain" not in runs
                  or not any(runs["plain"]["launches"].values()),
                  f"{label}: the plain route launched a kernel")
            print(f"  20b {label}: launches a round: plane {got_plane} | "
                  f"legacy {got_legacy}")
            peaks += [(f"{label} {r}", runs[r]["peak"], reckoned[r])
                      for r in runs]
    lo_, hi_ = PEAK_RATIO_BAND
    for label, measured, reckoned in peaks:
        ratio = measured / reckoned
        print(f"  20b {label}: reckoned {reckoned:.2f} GB, measured "
              f"(max_memory_allocated) {measured:.2f} GB, ratio {ratio:.4f} "
              f"(band {lo_}-{hi_})")
        check(lo_ <= ratio <= hi_, f"{label}: measured / reckoned peak "
                                   f"{ratio:.4f} outside {PEAK_RATIO_BAND}")
    return total


def legacy_bf16_route_phase(torch, p19_masks):
    """20c: llama3.2-1b at full width on the legacy route at bfloat16 (the
    19b trainings with ``use_pallas_comm=True``): masks equal to 19b's
    plane runs; → their launches."""
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import TrainerConfig, param_layout

    per = 2 * param_layout(get_config("llama3.2-1b")).num_leaves
    total = {}
    for arch, ckw, tkw in BF16_TRAIN:
        cfg = get_config(arch, **ckw)
        tcfg = TrainerConfig(num_workers=2, lr=0.3, **tkw)
        run = mixed_route_run(torch, cfg, tcfg, "legacy", 4, 2)
        label = f"{arch} {'bfloat16' if ckw else 'float32'} {tkw['algo']}" \
            + (" grad_hat_dtype=bfloat16" if "grad_hat_dtype" in tkw else "")
        print(run_line(f"20c {label} legacy route", run))
        masks = [r["mask"] for r in run["rounds"]]
        check(masks == p19_masks[label], f"{label}: legacy masks {masks} vs "
                                         f"19b's plane {p19_masks[label]}")
        sfx = "_bb" if ckw else "_fb"
        want = {"lag-wk": {("sqnorm_2d_bf16" if ckw else "sqnorm_2d"): per},
                "laq@4": {"innovation_absmax_2d" + sfx: per,
                          "laq_encode_2d" + sfx: per}}[tkw["algo"]]
        got = {k: v / 4 for k, v in run["launches"].items() if v}
        check(got == want, f"{label}: legacy launches {got} a round, want "
                           f"{want}")
        print(f"  20c {label}: masks equal to 19b's plane run; launches a "
              f"round {got}")
        for k, v in run["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# Phase 21: bfloat16 training on the pods, async and fleet topologies
# ---------------------------------------------------------------------------

def topology_run(torch, cfg, tcfg, spec, churn=0.0, selection="uniform",
                 steps=4, seed=0, ckpt_at=None):
    """``steps`` rounds of ``spec``'s step on the card (batch 4, seq 256,
    weights from ``seed``): the trainer's for pods and async, the fleet's
    for ``fleet:N@k`` (its default host draws).  Returns the rounds'
    losses, masks (the cohort's for a fleet), cohorts and timings, the
    peak, every instantiation's launches, the state's dtypes and, with
    ``ckpt_at``, the state saved after that round, restored into a fresh
    state (weights from another seed) and run on to ``steps``: its rounds,
    θ against the uninterrupted θ, save and restore seconds."""
    import shutil
    import tempfile

    from repro_torch import fleet
    from repro_torch.checkpoint import restore, save
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.dist import lag_trainer as lt
    from repro_torch.engine import make_topology
    from repro_torch.fastpath import kernels
    from repro_torch.fastpath.layout import parts_of
    from repro_torch.fleet.population import MIRROR_PREFIX
    from repro_torch.kernels.lag_trigger import lag_trigger as legacy

    def fresh(seed):
        topo = make_topology(spec)
        if topo.name == "fleet":
            topo = fleet.FleetTopology(topo.population, topo.cohort,
                                       churn=churn, selection=selection)
            return (fleet.init_fleet_state(cfg, tcfg, topo, device="cuda",
                                           seed=seed),
                    fleet.make_fleet_step(cfg, tcfg, topo))
        return (lt.init_state(cfg, tcfg, device="cuda", seed=seed,
                              topology=topo),
                lt.make_train_step(cfg, tcfg, topology=topo))

    def rounds_of(state, step, k0, k1, out):
        stream = TokenStream(cfg.vocab_size)
        for k in range(k0, k1):
            batch = make_inputs(cfg, stream, k, 4, 256, device="cuda")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            mask = m.get("cohort_comm", m["comm_mask"])
            out.append(dict(loss=float(m["loss"]),
                            mask=mask.to(torch.int32).tolist(),
                            cohort=m["cohort_ids"].tolist()
                            if "cohort_ids" in m else None,
                            skipped=int(m["skipped_round"]),
                            ms=(time.perf_counter() - t0) * 1e3,
                            **lt.phase_ms(m)))
            if ckpt_at is not None and k + 1 == ckpt_at and k1 == steps \
                    and k0 == 0:
                t0 = time.perf_counter()
                save(tmp, ckpt_at, state)
                res["save_s"] = time.perf_counter() - t0
        return state

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    legacy.reset_launches()
    res, rounds = {}, []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_bf16_ckpt_") \
        if ckpt_at is not None else None
    try:
        state, step = fresh(seed)
        state = rounds_of(state, step, 0, steps, rounds)
        res.update(rounds=rounds, peak=torch.cuda.max_memory_allocated() / 1e9,
                   launches={**kernels.LAUNCHES, **legacy.LAUNCHES})
        theta = [t.clone() for t in parts_of(state["theta"])]
        res["theta_dtypes"] = [t.dtype for t in theta]
        lag = state["lag"]
        if "theta_ring" in lag:
            res["ring"] = [(t.dtype, tuple(t.shape))
                           for t in parts_of(lag["theta_ring"])]
        res["rows"] = sorted({str(v.dtype) for k, v in lag.items()
                              if k.startswith(MIRROR_PREFIX)})
        check(all(bool(torch.isfinite(t).all()) for t in theta),
              f"{spec}: non-finite parameters")
        del state, step, lag
        if ckpt_at is not None:
            gc.collect()
            torch.cuda.empty_cache()
            res["ckpt_gb"] = sum(os.path.getsize(os.path.join(tmp, f))
                                 for f in os.listdir(tmp)) / 1e9
            state, step = fresh(seed + 1)
            t0 = time.perf_counter()
            state, k = restore(tmp, state)
            torch.cuda.synchronize()
            res["restore_s"] = time.perf_counter() - t0
            check(k == ckpt_at, f"{spec}: restored step {k}")
            resumed = []
            state = rounds_of(state, step, ckpt_at, steps, resumed)
            res["resumed"] = resumed
            res["resumed_bitwise"] = all(
                bitwise(torch, a, b)
                for a, b in zip(parts_of(state["theta"]), theta))
            del state, step
    finally:
        if tmp is not None:
            shutil.rmtree(tmp)
    del theta
    gc.collect()
    torch.cuda.empty_cache()
    check(all(math.isfinite(r["loss"]) for r in rounds),
          f"{spec}: non-finite loss")
    steady = rounds[1:]
    res["mean"] = {k: sum(r[k] for r in steady) / len(steady)
                   for k in ("ms", "grad_ms", "comm_ms")}
    return res


def bf16_topology_phase(torch, runs19):
    """21: PHASE21's runs, each with its exact launches a round; the pods'
    and the full-cohort fleet's trajectories against 19b's shards runs;
    PHASE21_CKPT's run checkpointed at PHASE21_CKPT_AT and resumed;
    → their launches."""
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import TrainerConfig

    total, resumed = {}, False
    for arch, ckw, tkw, spec, churn, sel, route, want, ref in PHASE21:
        cfg = get_config(arch, **ckw)
        units = int(spec.split("@")[1]) if spec.startswith("fleet") else 2
        tcfg = TrainerConfig(num_workers=units, lr=0.3,
                             use_pallas_comm=route == "legacy", **tkw)
        ckpt = PHASE21_CKPT_AT if (arch, spec) == PHASE21_CKPT else None
        resumed = resumed or ckpt is not None
        run = topology_run(torch, cfg, tcfg, spec, churn, sel, ckpt_at=ckpt)
        label = (f"21 {arch} {'bfloat16' if ckw else 'float32'} "
                 + " ".join(f"{k}={v}" if k != "algo" else v
                            for k, v in tkw.items())
                 + f" {spec}" + (f" churn {churn} {sel}" if churn else "")
                 + f" {route}")
        print(run_line(label, run))
        got = {k: v / 4 for k, v in run["launches"].items() if v}
        check(got == want, f"{label}: launched {got} a round, want {want}")
        check(run["peak"] < 80.0, f"{label}: peak {run['peak']:.2f} GB")
        wide = cfg.params_dtype == torch.float32
        check(run["theta_dtypes"] == ([torch.float32] if wide else
                                      [torch.bfloat16, torch.float32]
                                      if arch == "mamba2-370m"
                                      else [torch.bfloat16]),
              f"{label}: θ dtypes {run['theta_dtypes']}")
        if "ring" in run:
            check([d for d, _ in run["ring"]] == run["theta_dtypes"],
                  f"{label}: ring {run['ring']}")
        if spec.startswith("fleet"):
            check(run["rows"] == ["torch.float32"],
                  f"{label}: compact rows {run['rows']}")
            k = int(spec.split("@")[1])
            check(all(len(r["cohort"]) == k for r in run["rounds"]),
                  f"{label}: cohorts {[r['cohort'] for r in run['rounds']]}")
        extra = ""
        if "ring" in run:
            extra += f" | ring {run['ring']}"
        if spec.startswith("fleet"):
            extra += (f" | cohorts {[r['cohort'] for r in run['rounds']]} "
                      f"| compact rows {run['rows']}")
        if spec.startswith("pods"):
            extra += (f" | rounds skipped "
                      f"{sum(r['skipped'] for r in run['rounds'])}")
        print(f"  {label}: launches a round {got}{extra}")
        if ref is not None:
            base, how = ref
            want_r = runs19[base]
            check([r["mask"] for r in run["rounds"]]
                  == [r["mask"] for r in want_r],
                  f"{label}: masks differ from 19b's {base}")
            if how == "bitwise":
                check([r["loss"] for r in run["rounds"]]
                      == [r["loss"] for r in want_r],
                      f"{label}: losses differ from 19b's {base}")
            what = "masks and losses bitwise" if how == "bitwise" \
                else "masks equal to"
            print(f"  {label}: {what} 19b's {base} (shards)")
        if ckpt is not None:
            whole = run["rounds"][ckpt:]
            same = [(r["loss"], r["mask"]) for r in run["resumed"]] \
                == [(r["loss"], r["mask"]) for r in whole]
            check(same and run["resumed_bitwise"],
                  f"{label}: rounds {ckpt + 1}-4 resumed from round {ckpt} "
                  f"differ from the uninterrupted run")
            print(f"  {label}: checkpoint at round {ckpt} "
                  f"({run['ckpt_gb']:.2f} GB) saved in {run['save_s']:.1f} s,"
                  f" restored into a fresh state in {run['restore_s']:.1f} s;"
                  f" rounds {ckpt + 1}-4 bitwise the uninterrupted run "
                  f"(losses, masks, θ)")
        for k, v in run["launches"].items():
            total[k] = total.get(k, 0) + v
    check(resumed, f"21: {PHASE21_CKPT} was not checkpointed")
    return total


# ---------------------------------------------------------------------------
# Phase 22: float16 training and serving; kernels 6 and 7 at every width and
# head_dim
# ---------------------------------------------------------------------------

def f16_edges(x):
    """A float32 ``x`` with entries at float16's edges, in place: every
    997th times 1e-5 (into float16's subnormals, below 2^-14), every 1009th
    3e-8 (about its smallest subnormal 2^-24: rounds to it or to 0), every
    1013th +65504 and every 2027th -65504 (its largest finite values: sums
    of two overflow to ±inf on the write)."""
    v = x.view(-1)
    v[::997] *= 1e-5
    v[5::1009] = 3e-8
    v[7::1013] = 65504.0
    v[11::2027] = -65504.0
    return x


def sqnorm_blocks_half(torch, dev):
    """22a: kernel 5 (``sqnorm_blocks``, on no path) at bfloat16 and
    float16 at phase 4's shape (W = 2, full width): bitwise the float32
    kernel on the widened operand, the partials within SUM_RTOL of the plain
    version; read steadily (``steady_ms``: the median and min-max of 50
    single launches) beside ``torch.linalg.vector_norm``, flat and per
    1024-element sub-block (the one call that writes per-sub-block
    results); → its rows of the kernels line (the medians)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import param_layout
    from repro_torch.fastpath import kernels, kernels_ref

    R = param_layout(get_config("llama3.2-1b")).rows
    W, step = 2, 1 << 19
    N, S = W * R * 128, W * R // 8
    gen = torch.Generator(device=dev)
    gen.manual_seed(225)
    rows = {}
    for dt, sfx in ((torch.bfloat16, "_bf16"), (torch.float16, "_f16")):
        x = torch.randn((W, R, 128), device=dev, generator=gen)
        a = (f16_edges(x) if dt == torch.float16 else x).to(dt)
        del x
        got = kernels.sqnorm_blocks(a)
        err = 0.0
        for r0 in range(0, R, step):
            r1 = min(r0 + step, R)
            sr = slice(r0 // 8, r1 // 8)
            check(bitwise(torch, got[:, sr], kernels.sqnorm_blocks(
                a[:, r0:r1].float().contiguous())),
                f"sqnorm_blocks{sfx}: not the float32 kernel's")
            want = kernels_ref.sqnorm_blocks(a[:, r0:r1])
            torch.testing.assert_close(got[:, sr], want, rtol=SUM_RTOL,
                                       atol=0)
            err = max(err, max_abs(got[:, sr], want))
        t_b, by = bound_ms(N * 2 + S * 4, 2 * N)
        flat, subs = a.view(-1), a.view(-1, 1024)
        kern = steady_ms(torch, lambda: kernels.sqnorm_blocks(a))
        lib = steady_ms(torch, lambda: torch.linalg.vector_norm(flat))
        lib_sub = steady_ms(torch, lambda: torch.linalg.vector_norm(
            subs, dim=1, dtype=torch.float32))
        r = rows["sqnorm_blocks" + sfx] = dict(
            max_abs_err=err, ms=kern[0],
            plain_ms=cuda_ms(torch, lambda: [kernels_ref.sqnorm_blocks(
                a[:, r0:r0 + step]) for r0 in range(0, R, step)], n=2),
            bound_ms=t_b, bound_by=by, library_ms=lib[0])
        print(f"  22a sqnorm_blocks{sfx}: max_abs_err {err:.3e} | "
              f"median (min–max) of 50: {steady_line(kern)} (plain "
              f"{r['plain_ms']:.3f} ms, bound {t_b:.4f} ms by {by}; "
              f"vector_norm flat {steady_line(lib)}, per sub-block "
              f"{steady_line(lib_sub)}) | bound / kernel "
              f"{t_b / r['ms']:.1%}, kernel / vector_norm "
              f"{r['ms'] / r['library_ms']:.3f}")
        del a, got, flat, subs
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def rms_rows_kernel_phase(torch, dev, gen, bad):
    """22a: the rows kernel (what the TMA stream does not take) at
    RMS_ROWS_WIDTHS in all three dtypes, rows 1, 7 and 1000, and 9
    contiguous rows one to three elements off an aligned base: float32
    within MODEL_TOL of the plain version, a 2-byte dtype as
    ``bf16_rms_case`` holds it (bitwise the float32 kernel on the aligned
    widened row); every launch counted on the rows kernel's instantiation
    and on the path ``rms.rows_path`` names (``rms.rows_counts``); at
    widths the stream takes (RMS_STREAM_OFF), one to three elements off,
    bitwise the stream's output on an aligned copy; then (8192, d) timed at
    RMS_ROWS_TIMED, beside ``F.rms_norm``.  → its rows of the kernels line
    (at d RMS_ROWS_TIMED[0])."""
    from repro_torch.kernels.rmsnorm import ref as rms_ref
    from repro_torch.kernels.rmsnorm import rmsnorm as rms

    F = torch.nn.functional
    names = {dt: name for dt, (name, _) in rms.ROWS_ENTRIES.items()}
    rows = {}

    def offset(t, off):
        """``t`` contiguous, ``off`` elements past an aligned base."""
        buf = t.new_empty(t.numel() + off)
        return buf[off:].view_as(t).copy_(t)

    for dt in (torch.float32, torch.bfloat16, torch.float16):
        worst = 0.0
        for d in RMS_ROWS_WIDTHS:
            # (rows, elements past an aligned base, the scale's likewise)
            for n, off in ((1, 0), (7, 0), (1000, 0), (9, 1), (9, 2), (9, 3)):
                x = offset(torch.randn((n, d), device=dev,
                                       generator=gen).to(dt), off)
                sc = offset(torch.randn((d,), device=dev,
                                        generator=gen).to(dt), off)
                what = f"rmsnorm rows {dt} ({n}, {d}) offset {off}"
                if off and rms.stream_takes(x, sc):
                    bad.append(f"{what}: the stream kernel's rule takes it")
                before = rms.LAUNCHES[names[dt]]
                path = rms.ROWS_PATHS.index(rms.rows_path(x))
                if path != (1 if off else 0):
                    bad.append(f"{what}: path {rms.ROWS_PATHS[path]}")
                loads = rms.rows_counts()[dt]
                if dt == torch.float32:
                    got = rms.rmsnorm_2d(x, sc)
                    e = max_abs(got, rms_ref.rmsnorm(x, sc))
                    if not e <= MODEL_TOL * max(1.0, float(got.abs().max())):
                        bad.append(f"{what}: {e}")
                else:
                    _, e, b = bf16_rms_case(torch, x, sc)
                    bad += [f"{what}: {m}" for m in b]
                worst = max(worst, e)
                # the 2-byte case launches the float32 rows kernel too
                if rms.LAUNCHES[names[dt]] == before:
                    bad.append(f"{what}: not the rows kernel")
                now = rms.rows_counts()[dt]
                if [a - b for a, b in zip(now, loads)] != [
                        int(i == path) for i in range(3)]:
                    bad.append(f"{what}: rows kernel paths {loads} -> {now},"
                               f" want one on {rms.ROWS_PATHS[path]}")
        for d in RMS_STREAM_OFF:
            for off in (1, 2, 3):
                x = torch.randn((100, d), device=dev, generator=gen).to(dt)
                sc = torch.randn((d,), device=dev, generator=gen).to(dt)
                got = rms.rmsnorm_2d(offset(x, off), offset(sc, off))
                if not bitwise(torch, got, rms.rmsnorm_2d(x, sc)):
                    bad.append(f"rmsnorm rows {dt} (100, {d}) offset {off}: "
                               f"not the stream's output")
        print(f"  22a rmsnorm rows kernel {dt}: d {RMS_ROWS_WIDTHS}, rows 1,"
              f" 7, 1000 and 9 contiguous rows 1 to 3 elements off an "
              f"aligned base, max |Δ| {worst:.3e} against the "
              f"{'plain' if dt == torch.float32 else 'widened plain'} "
              f"version; d {RMS_STREAM_OFF} 1 to 3 elements off bitwise the "
              f"stream's output")
        for d in RMS_ROWS_TIMED:
            R = RMS_FULL[0]
            x = torch.randn((R, d), device=dev, generator=gen).to(dt)
            sc = torch.randn((d,), device=dev, generator=gen).to(dt)
            # the timed shape held too: its tiles wrap every block's ring
            if dt == torch.float32:
                e = max_abs(rms.rmsnorm_2d(x, sc), rms_ref.rmsnorm(x, sc))
                if not e <= MODEL_TOL * max(1.0, float(x.abs().max())):
                    bad.append(f"rmsnorm rows f32 ({R}, {d}): {e}")
            else:
                _, e, b = bf16_rms_case(torch, x, sc)
                bad += [f"rmsnorm rows {dt} ({R}, {d}): {m}" for m in b]
            worst = max(worst, e)
            size = x.element_size()
            t_b, by = bound_ms(2 * R * d * size + d * size, 4 * R * d)
            r_ = dict(
                max_abs_err=worst,
                ms=cuda_ms(torch, lambda: rms.rmsnorm_2d(x, sc), n=20),
                plain_ms=cuda_ms(torch, lambda: rms_ref.rmsnorm(x, sc), n=5),
                bound_ms=t_b, bound_by=by,
                library_ms=cuda_ms(torch, lambda: F.rms_norm(x, (d,), sc,
                                                            1e-6), n=20))
            print(f"  22a rmsnorm rows {dt} ({R}, {d}): {r_['ms']:.4f} ms "
                  f"(plain {r_['plain_ms']:.4f}, bound {t_b:.4f} ms by {by}"
                  f" = {t_b / r_['ms']:.1%}, F.rms_norm "
                  f"{r_['library_ms']:.4f} ms, kernel / library "
                  f"{r_['ms'] / r_['library_ms']:.3f})")
            if d == RMS_ROWS_TIMED[0]:
                rows[names[dt]] = r_
            del x, sc
    return rows


def flash_wide_case(torch, q, k, v, causal, window, bad, what):
    """A wide-kernel launch (head_dim above 256) against the plain version:
    float32 within MODEL_TOL, a 2-byte dtype as ``bf16_flash_case``.  →
    max |Δ|."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    if q.dtype != torch.float32:
        e, b = bf16_flash_case(torch, q, k, v, causal, window)
        bad += [f"{what}: {m}" for m in b]
        return e
    got = fa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    want = fa_ref.attention(q, k, v, causal=causal, window=window)
    S, Skv = q.shape[1], k.shape[1]
    if S > Skv and window is not None:
        live = torch.arange(S, device=q.device) - window + 1 < Skv
        got, want = got[:, live], want[:, live]
    e = max_abs(got, want)
    if not (bool(torch.isfinite(got).all()) and e <= MODEL_TOL):
        bad.append(f"{what}: {e:.3e}")
    return e


def flash_library_ms(torch, q, k, v, causal, window):
    """``F.scaled_dot_product_attention`` on the same (B, S, H, hd) inputs
    (GQA by ``enable_gqa``, a window as a boolean mask), ms."""
    F = torch.nn.functional
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    mask = None
    if window is not None:
        S, Skv = q.shape[1], k.shape[1]
        qp = torch.arange(S, device=q.device)[:, None]
        kp = torch.arange(Skv, device=q.device)[None, :]
        mask = (qp - kp < window) & ((qp >= kp) if causal else True)
    return cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=True), n=5)


def flash_f16_and_wide_phase(torch, dev, gen, bad):
    """22a: the float16 flash kernel on the ragged set at head_dim 64 and
    256, phase 18a's eight shapes and the dominant-key row (one key per row
    ahead by 18, the rest's weights about 1.5e-8: the float16 P split's
    trouble), each within one float16 ulp (+ 1e-6) of the widened plain
    version rounded; the wide kernel (head_dim above 256) on a ragged set
    and at ATTN_WIDE_HD in all three dtypes.  → the kernels line's rows of
    ``flash_attention_f16`` (at ATTN_FULL) and the wide kernel's (at
    ATTN_WIDE_HD[0])."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref as fa_ref

    h16 = torch.float16
    rows = {}

    def randn(dt, *shape):
        return torch.randn(shape, device=dev, generator=gen).to(dt)

    for hd, H, KV in ((64, 32, 8), (256, 16, 1)):
        cases = [(S, S, c, w) for S in FLASH_S for c, w in FLASH_MASKS]
        cases += FLASH_CROSS
        worst = 0.0
        for S, Skv, causal, window in cases:
            e, b = bf16_flash_case(torch, randn(h16, 1, S, H, hd),
                                   randn(h16, 1, Skv, KV, hd),
                                   randn(h16, 1, Skv, KV, hd), causal, window)
            worst = max(worst, e)
            bad += [f"flash f16 hd {hd} Sq {S} Skv {Skv} causal {causal} "
                    f"window {window}: {m}" for m in b]
        print(f"  22a flash_attention f16 hd {hd} H {H}/{KV}: {len(cases)} "
              f"ragged cases, max |Δ| {worst:.3e} against the widened plain "
              f"version rounded")
    # the dominant-key rows: key 0 ahead of the others by 18 in every row,
    # their weights about e^-18 = 1.5e-8 (below float16's 2^-24), v 0 at
    # key 0: the output is theirs alone
    S, hd = 2048, 64
    q = torch.zeros((1, S, 2, hd), device=dev)
    q[..., 0] = 6.0
    k = randn(torch.float32, 1, S, 1, hd) * 0.01
    k[:, 0, :, 0] = 24.0              # 6 · 24 · 64^-0.5 = 18
    v = torch.rand((1, S, 1, hd), device=dev, generator=gen)
    v[:, 0] = 0.0
    e, b = bf16_flash_case(torch, q.to(h16), k.to(h16), v.to(h16), True,
                           None)
    bad += [f"flash f16 dominant-key row: {m}" for m in b]
    print(f"  22a flash_attention f16 dominant-key rows (S {S}): max |Δ| "
          f"{e:.3e} against the widened plain version rounded")
    for B, S, H, KV, hd, causal, window in ATTN_BF16:
        q, k, v = (randn(h16, B, S, H, hd), randn(h16, B, S, KV, hd),
                   randn(h16, B, S, KV, hd))
        e, b = bf16_flash_case(torch, q, k, v, causal, window)
        bad += [f"flash f16 full {(B, S, H, KV, hd)}: {m}" for m in b]
        ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal, window=window), n=10)
        lib = flash_library_ms(torch, q, k, v, causal, window)
        # the (query, key) pairs the masks leave, 4·hd FLOP each, at the
        # tensor cores' float16 rate; the design's 1 + 2 products 1.5 ×
        pos = torch.arange(S, device=dev)
        keep = pos[:, None] >= pos[None] if causal else \
            torch.ones((S, S), dtype=torch.bool, device=dev)
        if window is not None:
            keep &= pos[:, None] - pos[None] < window
        flop = 4 * hd * B * H * int(keep.sum())
        nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
        t_b, by = bound_ms(nbytes, flop, BF16_FLOP_PER_S)
        line = (f"  22a flash_attention f16 ({B}, {S}, {H}/{KV}, {hd}) "
                f"{'causal' if causal else 'non-causal'}"
                + (f" window {window}" if window else "")
                + f": max |Δ| {e:.3e} | {ms:.4f} ms (SDPA f16 {lib:.4f} ms, "
                f"kernel / library {ms / lib:.3f}; bound {t_b:.4f} ms by "
                f"{by} = {t_b / ms:.1%}, the design's 1 + 2 float16 products "
                f"{1.5 * t_b:.4f} ms = {1.5 * t_b / ms:.1%})")
        if (B, S, H, KV, hd) == ATTN_FULL:
            r = rows["flash_attention_f16"] = dict(
                max_abs_err=e, ms=ms,
                plain_ms=cuda_ms(torch, lambda: fa_ref.attention(
                    q, k, v, causal=causal), n=3),
                bound_ms=t_b, bound_by=by, library_ms=lib)
            line += f" (plain {r['plain_ms']:.4f} ms)"
        print(line)
        del keep
        del q, k, v
    # the wide kernel: ragged, then the timed shapes, in all three dtypes
    for dt in (torch.float32, torch.bfloat16, h16):
        worst = 0.0
        for hd in ATTN_WIDE_RAGGED:
            for S, Skv, causal, window in ((1, 1, True, None),
                                           (65, 65, True, 16),
                                           (129, 129, True, None),
                                           (129, 1000, False, None),
                                           (1000, 129, True, 64),
                                           (200, 200, False, None)):
                worst = max(worst, flash_wide_case(
                    torch, randn(dt, 1, S, 4, hd), randn(dt, 1, Skv, 2, hd),
                    randn(dt, 1, Skv, 2, hd), causal, window, bad,
                    f"flash wide {dt} hd {hd} Sq {S} Skv {Skv} causal "
                    f"{causal} window {window}"))
        for B, S, H, KV, hd, causal, window in ATTN_WIDE_HD:
            q, k, v = (randn(dt, B, S, H, hd), randn(dt, B, S, KV, hd),
                       randn(dt, B, S, KV, hd))
            e = flash_wide_case(torch, q, k, v, causal, window, bad,
                                f"flash wide {dt} {(B, S, H, KV, hd)}")
            worst = max(worst, e)
            flop = 4 * B * H * hd * (S * (S + 1) // 2)
            size = q.element_size()
            nbytes = size * (2 * B * S * H * hd + 2 * B * S * KV * hd)
            if dt == torch.float32:
                # split TF32: three TF32 products per float32 product
                t_b, by = bound_ms(nbytes, 3 * flop, TF32_FLOP_PER_S)
                other = (f"the FMA units' "
                         f"{bound_ms(nbytes, flop, F32_FLOP_PER_S)[0]:.4f} ms")
            else:
                t_b, by = bound_ms(nbytes, flop, BF16_FLOP_PER_S)
                terms = 3 if dt == torch.bfloat16 else 2
                other = (f"the design's 1 + {terms} products "
                         f"{t_b * (1 + terms) / 2:.4f} ms")
            r = dict(max_abs_err=e, ms=cuda_ms(
                torch, lambda: fa.flash_attention_fwd(q, k, v,
                                                      causal=causal), n=5),
                plain_ms=cuda_ms(torch, lambda: fa_ref.attention(
                    q, k, v, causal=causal), n=2),
                bound_ms=t_b, bound_by=by,
                library_ms=flash_library_ms(torch, q, k, v, causal, None))
            print(f"  22a flash_attention wide {dt} ({B}, {S}, {H}/{KV}, "
                  f"{hd}) causal: max |Δ| {e:.3e} | {r['ms']:.4f} ms (plain "
                  f"{r['plain_ms']:.3f} ms, bound {t_b:.4f} ms by {by} = "
                  f"{t_b / r['ms']:.2%}; {other}; SDPA "
                  f"{r['library_ms']:.4f} ms, kernel / library "
                  f"{r['ms'] / r['library_ms']:.3f})")
            if hd == ATTN_WIDE_HD[0][4]:
                rows[fa.WIDE_ENTRIES[dt][0]] = r
            del q, k, v
        print(f"  22a flash_attention wide {dt}: ragged cases at hd "
              f"{ATTN_WIDE_RAGGED}, full at "
              f"{tuple(c[4] for c in ATTN_WIDE_HD)}, max |Δ| {worst:.3e}")
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def f16_kernel_phase(torch, dev):
    """22a: every float16 instantiation of kernels 1-12 against its plain
    version, kernel 5 at bfloat16 too, the rows RMSNorm kernel and the wide
    flash kernel in all three dtypes; → the kernels line's rows of them."""
    rows = dict(bf16_plane_kernel_phase(torch, dev, torch.float16,
                                        F16_COMBOS, "22a"))
    rows.update(sqnorm_blocks_half(torch, dev))
    rows.update(legacy_bf16_kernel_phase(torch, dev, torch.float16,
                                         F16_COMBOS, "22a"))
    gen = torch.Generator(device=dev)
    gen.manual_seed(22)
    bad = []
    for d in BF16_RMS_WIDTHS:
        worst = 0.0
        for r in (1, 7, 129, 1000):
            x = torch.randn((r, d), device=dev, generator=gen)
            _, e, b = bf16_rms_case(torch, f16_edges(x).half(), torch.randn(
                (d,), device=dev, generator=gen).half())
            worst = max(worst, e)
            bad += [f"rmsnorm f16 ({r}, {d}): {m}" for m in b]
        print(f"  22a rmsnorm f16 d {d}: rows 1, 7, 129, 1000, max |Δ| "
              f"{worst:.3e} against the widened plain version")
    rows["rmsnorm_f16"] = rms_timing(torch, dev, gen, bad, (RMS_FULL[1],),
                                     torch.float16)[RMS_FULL[1]]
    rows.update(rms_rows_kernel_phase(torch, dev, gen, bad))
    rows.update(flash_f16_and_wide_phase(torch, dev, gen, bad))
    check(not bad, f"22a: {bad[:10]} ({len(bad)} failures)")
    return rows


def f16_serve(torch, dev):
    """22b: llama3.2-1b float16 through ``launch.serve`` with
    ``use_pallas=True`` (batch 4, prompt 2048, 32 greedy tokens), its
    weights the float32 model's rounded to float16: the kernel route
    against the plain route and each against the float32 logits, as 18b;
    33 RMSNorm and 16 flash launches a prefill."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model

    cfg32 = get_config("llama3.2-1b")
    cfg = cfg32.replace(**F16)
    args = serve.build_argparser().parse_args(SERVE_ARGS)
    gc.collect()
    torch.cuda.empty_cache()
    p32 = model.init(cfg32, device=dev, seed=args.seed)
    prompts = torch.from_numpy(serve.make_prompts(
        cfg.vocab_size, args.batch, args.prompt_len, args.seed + 1)).to(dev)
    with torch.inference_mode():
        f32_logits = model.prefill(p32, cfg32, {"tokens": prompts},
                                   max_len=args.prompt_len + args.gen)[0]
    params = as_bf16(torch, p32, cfg)
    del p32
    got, _ = serve_phase(torch, dev, SERVE_ARGS, cfg=cfg, params=params,
                         f32_logits=f32_logits.float())
    want = {k + "_f16": v for k, v in prefill_launches(cfg).items()}
    check(got == {k: 2 * v for k, v in want.items()},
          f"22b launches {got}, want {want} a prefill")
    print(f"  22b launches a prefill: { {k: v // 2 for k, v in got.items()} }")
    return got


def f16_training_phase(torch):
    """22c: F16_TRAIN's runs, each route of a label against its first
    (the plane) with equal masks and |Δ loss| within BF16_ROUTE_FACTOR ×
    F16_ROUTE_LOSS_READINGS; exact launches a round; each peak within
    PEAK_RATIO_BAND of the dry-run's reckoning; pods:2 and fleet:2@2
    against the shards run bit for bit; → the launches."""
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import TrainerConfig

    total, base = {}, {}
    lo, hi = PEAK_RATIO_BAND
    for arch, ckw, tkw, route, want in F16_TRAIN:
        cfg = get_config(arch, **ckw)
        tcfg = TrainerConfig(num_workers=2, lr=0.3, **tkw)
        label = (f"22c {arch} {'float16' if ckw else 'float32'} "
                 + " ".join(f"{k}={v}" if k != "algo" else v
                            for k, v in tkw.items()))
        if route.startswith(("pods", "fleet")):
            units = int(route.split("@")[1]) if "@" in route else 2
            run = topology_run(torch, cfg, tcfg.replace(num_workers=units),
                               route)
        else:
            run = mixed_route_run(torch, cfg, tcfg, route, 4, 2)
        print(run_line(f"{label} {route}", run))
        got = {k: v / 4 for k, v in run["launches"].items() if v}
        check(got == want, f"{label} {route}: launched {got} a round, want "
                           f"{want}")
        check(run["peak"] < 80.0, f"{label}: peak {run['peak']:.2f} GB")
        for k, v in run["launches"].items():
            total[k] = total.get(k, 0) + v
        losses = [r["loss"] for r in run["rounds"]]
        masks = [r["mask"] for r in run["rounds"]]
        if route in ("plane", "legacy", "plain"):
            reckoned = reckoned_peak_gb(cfg, tcfg, route)
            ratio = run["peak"] / reckoned
            print(f"  {label} {route}: reckoned {reckoned:.2f} GB, measured "
                  f"{run['peak']:.2f} GB, ratio {ratio:.4f} (band {lo}-{hi})"
                  f" | launches a round {got}")
            check(lo <= ratio <= hi, f"{label} {route}: peak ratio {ratio}")
        if label not in base:
            base[label] = (losses, masks)
            continue
        bl, bm = base[label]
        check(masks == bm, f"{label} {route}: masks differ from the plane's")
        dl = max(abs(a - b) for a, b in zip(losses, bl))
        key = f"{label[4:]} {route}"
        if route.startswith(("pods", "fleet")):
            check(dl == 0.0, f"{label} {route}: losses differ from shards")
            print(f"  {label} {route}: masks and losses bitwise the shards "
                  f"run")
            continue
        bound = BF16_ROUTE_FACTOR * F16_ROUTE_LOSS_READINGS[key]
        print(f"  {label} {route} vs plane: max |Δ loss| {dl:.3e} (bound "
              f"{bound:.3e}), masks equal")
        check(dl <= bound, f"{key}: |Δ loss| {dl}")
    return total


def phase22(torch, dev, full, launches):
    """Phase 22: 22a's kernel rows into ``full``, 22b's and 22c's launches
    into ``launches``; every float16 instantiation on a path launched."""
    t22 = time.perf_counter()
    full.update(f16_kernel_phase(torch, dev))
    p22 = f16_serve(torch, dev)
    for k, v in f16_training_phase(torch).items():
        p22[k] = p22.get(k, 0) + v
    for k, v in p22.items():
        launches[k] = launches.get(k, 0) + v
    for k in PLANE_F16 + LEGACY_F16 + ("rmsnorm_f16", "flash_attention_f16"):
        if k in OFF_PATH:
            print(f"  {k}: {launches.get(k, 0)} launches, exempt: "
                  f"{OFF_PATH[k]}")
            continue
        check(p22.get(k, 0) > 0, f"phase 22: {k} never launched")
    for k in RMS_ROWS + FLASH_WIDE:
        print(f"  {k}: {launches.get(k, 0)} launches, exempt: "
              f"{OFF_PATH[k]}")
    print(f"  phase 22 launches: { {k: v for k, v in p22.items() if v} } "
          f"in {time.perf_counter() - t22:.1f} s")


# ---------------------------------------------------------------------------
# Phase 23: the device plane (devices:D)
# ---------------------------------------------------------------------------

def bits_digest(torch, t):
    """An integer digest of a tensor's bits: Σ word_i·(i mod 65521 + 1)
    over its 32-bit (2-byte: 16-bit) words, mod 2^64 — int64 sums wrap and
    integer addition is associative, so the device's summation order does
    not matter.  Equal tensors give equal digests; one flipped bit changes
    it."""
    flat = t.detach().reshape(-1)
    words = flat.view(torch.int32 if flat.element_size() == 4
                      else torch.int16)
    total, step = 0, 1 << 26
    for i in range(0, words.numel(), step):
        w = words[i:i + step].to(torch.int64)
        idx = torch.arange(i, i + w.numel(), dtype=torch.int64,
                           device=w.device)
        total += int((w * (idx % 65521 + 1)).sum())
        del w, idx
    return total % (1 << 64)


def state_digests(torch, state):
    """Digests of a trainer state's θ and of each worker's ĝ row."""
    return {"theta": bits_digest(torch, state["theta"]),
            "grad_hat": [bits_digest(torch, r)
                         for r in state["lag"]["grad_hat"]]}


def wire_phase(torch, dev):
    """23a: the wire format on the card at llama3.2-1b's full-width layout
    (W = 1): LAQ's codes at 4 and 3 bits packed from the plane's own
    encode, unpacked whole and, as 23c's ranks do, row chunk by row chunk
    from a copy on the host — bitwise the payload; a quiet worker's slot
    all-zero; the dense wire the payload buffer itself (no copy).  Equal
    means IEEE-equal: a code rounded to −0 comes back +0, as in the
    reference's round trip."""
    from repro_torch import comm
    from repro_torch.comm.laq import pack_codes, unpack_codes
    from repro_torch.configs import get_config
    from repro_torch.devrun import runner
    from repro_torch.dist.lag_trainer import param_layout
    from repro_torch.fastpath.plan import FastPathPlan

    lo = param_layout(get_config("llama3.2-1b"))
    gen = torch.Generator(device=dev).manual_seed(23)
    g = lo.empty((1,), dev)
    g.normal_(generator=gen)
    q, e = torch.zeros_like(g), torch.zeros_like(g)
    on, off = (torch.ones(1, dtype=torch.bool, device=dev),
               torch.zeros(1, dtype=torch.bool, device=dev))
    plan = FastPathPlan("on")
    for bits in (4, 3):
        pay, resid, _, steps = plan.laq_encode(g, q, e, lo, bits=bits)
        del resid
        ms = cuda_ms(torch, lambda: pack_codes(lo, pay, steps, bits, on), n=3)
        codes, stw = pack_codes(lo, pay, steps, bits, on)
        ums = cuda_ms(torch, lambda: unpack_codes(lo, codes, stw, bits), n=3)
        check(torch.equal(unpack_codes(lo, codes, stw, bits), pay),
              f"23a laq@{bits}: the unpacked codes are not the payload")
        host = {"codes": codes.cpu(), "steps": stw.cpu()}
        pol = comm.make_policy(f"laq@{bits}")
        chunks = 0
        for r in range(0, lo.rows, runner.SUM_ROWS):
            rs = slice(r, min(r + runner.SUM_ROWS, lo.rows))
            piece = pol.wire_unpack(lo, host, rows=rs, device=dev)
            check(torch.equal(piece, pay[:, rs]),
                  f"23a laq@{bits}: rows {rs} unpacked from the host differ")
            chunks += 1
        quiet, qst = pack_codes(lo, pay, steps, bits, off)
        check(int(quiet.max()) == 0 and not bool(
            unpack_codes(lo, quiet, qst, bits).any()),
            f"23a laq@{bits}: a quiet slot is not all-zero")
        print(f"  laq@{bits}: codes {tuple(codes.shape)} {codes.dtype} "
              f"({codes.numel() / 1e9:.3f} GB) + steps {tuple(stw.shape)}; "
              f"pack {ms:.1f} ms, unpack {ums:.1f} ms; equal to the payload "
              f"whole and in {chunks} chunks from the host; quiet slot zero")
        del pay, codes, host, quiet
    dense = comm.make_policy("lag-wk")
    buf = g.clone()
    wire = dense.wire_pack(lo, buf, {}, on)
    check(wire["payload"].data_ptr() == buf.data_ptr()
          and torch.equal(dense.wire_unpack(lo, wire), g),
          "23a dense: the wire is not the payload buffer")
    print(f"  dense: the payload buffer itself ({g.numel() * 4 / 1e9:.3f} "
          f"GB, no copy), unpacked equal")
    del g, q, e, buf, wire
    gc.collect()
    torch.cuda.empty_cache()


def devices_one_phase(torch):
    """23b: ``devices:1`` over NCCL in this process (a group of one rank,
    which ``launch.train`` joins), lag-wk, 3 rounds, against ``shards:1``:
    masks, losses, θ and ĝ bitwise."""
    import shutil
    import tempfile
    import torch.distributed as dist

    shards = trainer_phase(torch, "lag-wk", steps=3, workers=1,
                           digest_after=3)
    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        dev = trainer_phase(torch, "lag-wk", steps=3, workers=1,
                            digest_after=3,
                            extra=("--topology", "devices:1",
                                   "--dist-backend", "nccl"))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    check([r["mask"] for r in dev["rounds"]]
          == [r["mask"] for r in shards["rounds"]]
          and [r["loss"] for r in dev["rounds"]]
          == [r["loss"] for r in shards["rounds"]],
          "23b: devices:1's masks or losses differ from shards:1's")
    check(dev["digest"] == shards["digest"],
          "23b: devices:1's θ or ĝ differ from shards:1's")
    print(f"  devices:1 (nccl) masks, losses, θ and ĝ bitwise shards:1's; "
          f"rounds 1-2 {dev['summary']['ms']:.1f} ms vs "
          f"{shards['summary']['ms']:.1f} ms a round")
    return dev["plane"]


DEVICES_ALGOS = (("lag-wk", True), ("laq@4", False))
DEVICES_STEPS = 3               # 23c's rounds: phase 5's first 3
DEVICES_QUIET = 1e9             # the history raised so that no worker fires


def devices_rank(rank, steps):
    """One rank of 23c, spawned by ``devrun.launch`` in a gloo group of 2
    sharing the card: ``steps`` rounds of phase 5's lag-wk (then one
    all-quiet round) and laq@4 runs at ``devices:2``, with the launcher's settings, weights and
    batches.  Returns each run's rounds (mask, loss, ms, gather ms, the
    collective records), digests, this rank's kernel launches and peak."""
    import torch
    from repro_torch import devrun
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.dist.lag_trainer import TrainerConfig, phase_ms
    from repro_torch.engine import make_topology
    from repro_torch.fastpath import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3.2-1b")
    out = {}
    for algo, quiet in DEVICES_ALGOS:
        tcfg = TrainerConfig(algo=algo, num_workers=2, lr=0.3, xi=0.1, D=10)
        topo = make_topology("devices:2")
        state = devrun.init_device_state(cfg, tcfg, device="cuda", seed=0,
                                         topology=topo)
        dev = state["theta"].device
        step = devrun.make_device_step(cfg, tcfg, topology=topo)
        stream = TokenStream(vocab=cfg.vocab_size, seed=0)
        kernels.reset_launches()
        torch.cuda.reset_peak_memory_stats(dev)
        rounds = []
        for k in range(steps + int(quiet)):
            if k == steps:
                state["lag"]["hist"] = state["lag"]["hist"] + DEVICES_QUIET
                before = bits_digest(torch, state["lag"]["grad_hat"])
            batch = make_inputs(cfg, stream, k, 4, 256, device=dev)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize(dev)
            rounds.append(dict(mask=m["comm_mask"].to(torch.int32).tolist(),
                               loss=float(m["loss"]),
                               ms=(time.perf_counter() - t0) * 1e3,
                               gather_ms=m["gather_ms"],
                               records=m["records"], **phase_ms(m)))
            if k == steps - 1:
                digest = state_digests(torch, state)
        if quiet:
            rounds[-1]["grad_hat_kept"] = before == bits_digest(
                torch, state["lag"]["grad_hat"])
        out[algo] = dict(rounds=rounds, digest=digest,
                         launches=dict(kernels.LAUNCHES),
                         peak=torch.cuda.max_memory_allocated(dev) / 1e9)
        del state, step, m, batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


def devices_two_phase(torch, phase5_runs, steps=None):
    """23c: ``devices:2`` over gloo, two rank processes sharing the card,
    phase 5's lag-wk and laq@4 for DEVICES_STEPS rounds against phase 5's
    ``shards:2`` runs (its state digested after as many rounds): masks and
    losses equal, θ and each worker's ĝ bitwise, every round's counted
    collective bytes exactly the wire format's prediction, lag-wk's
    all-quiet extra round moving the mask and the losses alone.  Returns
    the two ranks' kernel launches, summed."""
    steps = steps or DEVICES_STEPS
    from repro_torch import devrun
    from repro_torch.configs import get_config
    from repro_torch.dist.lag_trainer import TrainerConfig
    from repro_torch.models import model

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = devrun.launch(devices_rank, 2, backend="gloo", args=(steps,),
                          device="cuda", timeout=600.0)
    wall = time.perf_counter() - t0
    params = model.templates(get_config("llama3.2-1b"))
    launches = {}
    for algo, quiet in DEVICES_ALGOS:
        want = phase5_runs[algo]
        policy = TrainerConfig(algo=algo, num_workers=2).comm_policy()
        pred = devrun.predicted_collective_bytes(policy, params, 2)
        for rank, res in enumerate(ranks):
            got = res[algo]
            rounds, oracle = got["rounds"][:steps], want["rounds"][:steps]
            check([r["mask"] for r in rounds] == [r["mask"] for r in oracle],
                  f"23c {algo} rank {rank}: masks differ from phase 5's")
            check([r["loss"] for r in rounds] == [r["loss"] for r in oracle],
                  f"23c {algo} rank {rank}: losses differ from phase 5's: "
                  f"{[r['loss'] for r in rounds]} vs "
                  f"{[r['loss'] for r in oracle]}")
            check(got["digest"]["theta"] == want["digest"]["theta"],
                  f"23c {algo} rank {rank}: θ differs from phase 5's")
            check(got["digest"]["grad_hat"][0]
                  == want["digest"]["grad_hat"][rank],
                  f"23c {algo} rank {rank}: ĝ differs from phase 5's row")
            for k, r in enumerate(got["rounds"]):
                acct = devrun.check_wire_accounting(r["records"], policy,
                                                    params, 2)
                counted = acct["measured_total_bytes"]
                expect = pred["total"] if any(r["mask"]) \
                    else pred["mask_bytes"] + pred["loss_bytes"]
                check(counted == expect,
                      f"23c {algo} rank {rank} round {k}: counted {counted} "
                      f"bytes, predicted {expect}")
            if quiet:
                q = got["rounds"][-1]
                check(not any(q["mask"]) and q["grad_hat_kept"]
                      and {x["what"] for x in q["records"]}
                      == {"mask", "loss"},
                      f"23c {algo} rank {rank}: the quiet round {q['mask']} "
                      f"moved {[x['what'] for x in q['records']]}")
            names = ("delta_sqnorm_blocks", "masked_combine") \
                if algo == "lag-wk" else ("absmax_blocks",
                                          "laq_encode_blocks",
                                          "masked_combine")
            for n in names:
                check(got["launches"].get(n, 0) >= steps,
                      f"23c {algo} rank {rank}: {n} launched "
                      f"{got['launches'].get(n, 0)} times")
            for n, v in got["launches"].items():
                launches[n] = launches.get(n, 0) + v
            steady = rounds[1:]
            mean = lambda key: sum(r[key] for r in steady) / len(steady)
            print(f"  {algo} rank {rank}: masks {[r['mask'] for r in rounds]}"
                  f" and losses equal to phase 5's, θ and ĝ bitwise | rounds "
                  f"1-{steps - 1} mean {mean('ms'):.1f} ms (device fwd/bwd "
                  f"{mean('grad_ms'):.1f} ms), gather {mean('gather_ms'):.1f}"
                  f" ms (host clock, staged through host memory: no "
                  f"interconnect figure) | counted "
                  f"{pred['total']:.0f} B a fired round = predicted"
                  + (f"; quiet round {got['rounds'][-1]['gather_ms']:.1f} ms,"
                     f" {pred['mask_bytes'] + pred['loss_bytes']:.0f} B"
                     if quiet else "")
                  + f" | peak {got['peak']:.2f} GB")
    print(f"  phase 23c: 2 ranks, {wall:.1f} s with their start")
    return launches


def phase23(torch, dev, phase5_runs, launches, smi):
    """Phase 23: 23a's wire format, 23b's devices:1 (nccl) and 23c's
    devices:2 (gloo) launches into ``launches``."""
    t23 = time.perf_counter()
    wire_phase(torch, dev)
    p23 = devices_one_phase(torch)
    for k, v in devices_two_phase(torch, phase5_runs).items():
        p23[k] = p23.get(k, 0) + v
    for k, v in p23.items():
        launches[k] = launches.get(k, 0) + v
    print(f"  phase 23 launches: { {k: v for k, v in p23.items() if v} } "
          f"in {time.perf_counter() - t23:.1f} s on {smi}")


MESH_STEPS = 3                  # phase 24's rounds: phase 5's first 3
MESH_LAYERS = 2                 # 24b's depth (full width)
MESH_ALGOS = ("lag-wk", "laq@4")
#: the plane's kernels a round of each 24b algo launches on each rank
MESH_LAUNCHES = {"lag-wk": {"delta_sqnorm_blocks": 1, "masked_combine": 1},
                 "laq@4": {"absmax_blocks": 1, "laq_encode_blocks": 1,
                           "masked_combine": 2}}


def mesh_one_phase(torch, phase5_runs):
    """24a: ``launch.train --mesh host`` over NCCL at one rank in this
    process (a group of one that the launcher joins, so the row-sharded
    step runs with its collectives local), lag-wk, 3 rounds, against
    phase 5's first 3: masks, losses, θ and ĝ bitwise."""
    import shutil
    import tempfile
    import torch.distributed as dist

    tmp = tempfile.mkdtemp()
    dist.init_process_group("nccl", store=dist.FileStore(
        os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        run = trainer_phase(torch, "lag-wk", steps=MESH_STEPS,
                            digest_after=MESH_STEPS,
                            extra=("--mesh", "host", "--dist-backend",
                                   "nccl"))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    want = phase5_runs["lag-wk"]
    oracle = want["rounds"][:MESH_STEPS]
    check([r["mask"] for r in run["rounds"]] == [r["mask"] for r in oracle]
          and [r["loss"] for r in run["rounds"]]
          == [r["loss"] for r in oracle],
          "24a: the host mesh's masks or losses differ from phase 5's")
    check(run["digest"] == want["digest"],
          "24a: the host mesh's θ or ĝ differ from phase 5's")
    p5 = sum(r["ms"] for r in oracle[1:]) / (MESH_STEPS - 1)
    print(f"  24a --mesh host (nccl, 1 rank) lag-wk: masks, losses, θ and ĝ"
          f" bitwise phase 5's first {MESH_STEPS} rounds; rounds 1-"
          f"{MESH_STEPS - 1} {run['summary']['ms']:.1f} ms a round vs phase "
          f"5's {p5:.1f} ms | peak {run['peak']:.2f} GB")
    return run["plane"]


def mesh_config():
    from repro_torch.configs import get_config
    return get_config("llama3.2-1b").replace(num_layers=MESH_LAYERS)


def mesh_run(torch, algo, ghat_rows, mesh=None):
    """MESH_STEPS rounds of ``algo`` at 24b's config (the launcher's
    settings: W = 2, lr 0.3, seed 0, batch 4, seq 256) on the card, in one
    process (``mesh`` None) or on this rank's rows: masks, losses, ms, the
    collective records, the digests of θ (the layout's rows) and of ĝ's
    rows ``[start, stop)`` for each pair of ``ghat_rows``, ĝ's shape, the
    plane's launches and the peak."""
    from repro_torch.data import TokenStream, make_inputs
    from repro_torch.dist.lag_trainer import (TrainerConfig, init_state,
                                              make_train_step, param_layout)
    from repro_torch.fastpath import kernels

    cfg = mesh_config()
    tcfg = TrainerConfig(algo=algo, num_workers=2, lr=0.3, xi=0.1, D=10)
    dev = torch.device("cuda", torch.cuda.current_device())
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state = init_state(cfg, tcfg, device=dev, seed=0, mesh=mesh)
    step = make_train_step(cfg, tcfg, mesh=mesh)
    stream = TokenStream(vocab=cfg.vocab_size, seed=0)
    kernels.reset_launches()
    rounds = []
    for k in range(MESH_STEPS):
        batch = make_inputs(cfg, stream, k, 4, 256, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize(dev)
        rounds.append(dict(mask=m["comm_mask"].to(torch.int32).tolist(),
                           loss=float(m["loss"]),
                           ms=(time.perf_counter() - t0) * 1e3,
                           records=m.get("records")))
    gh = state["lag"]["grad_hat"]
    out = dict(rounds=rounds, launches=dict(kernels.LAUNCHES),
               theta=bits_digest(torch, state["theta"][
                   :param_layout(cfg).rows]),
               grad_hat=[bits_digest(torch, gh[:, a:b])
                         for a, b in ghat_rows],
               shape=tuple(gh.shape),
               peak=torch.cuda.max_memory_allocated(dev) / 1e9)
    del state, step, m, batch, gh
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mesh_rank(rank):
    """One rank of 24b, spawned by ``devrun.launch`` in a gloo group of 2
    sharing the card: MESH_ALGOS on the host mesh, this rank's rows."""
    import torch
    from repro_torch.dist import row_shards
    from repro_torch.dist.lag_trainer import TrainerConfig, param_layout
    from repro_torch.fastpath.layout import RowShard
    from repro_torch.launch.mesh import make_host_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    mesh = make_host_mesh("cpu")
    sh = RowShard(param_layout(mesh_config()).rows, 2, rank)
    out = {}
    for algo in MESH_ALGOS:
        out[algo] = mesh_run(torch, algo, [(0, sh.valid)], mesh=mesh)
        out[algo]["predicted"] = row_shards.predicted_records(
            mesh_config(), TrainerConfig(algo=algo, num_workers=2), mesh)
    return out


def mesh_two_phase(torch):
    """24b: two gloo ranks sharing the card against the one-process
    ``shards:2`` trainer at the same config (run here first).  Returns the
    ranks' plane launches, summed."""
    from repro_torch import devrun
    from repro_torch.dist.collectives import collective_bytes
    from repro_torch.dist.lag_trainer import param_layout
    from repro_torch.fastpath.layout import RowShard

    rows = param_layout(mesh_config()).rows
    shards = [RowShard(rows, 2, r) for r in range(2)]
    want = {algo: mesh_run(torch, algo, [(sh.start, sh.start + sh.valid)
                                         for sh in shards])
            for algo in MESH_ALGOS}
    t0 = time.perf_counter()
    ranks = devrun.launch(mesh_rank, 2, backend="gloo", device="cuda",
                          timeout=600.0)
    wall = time.perf_counter() - t0
    launches = {}
    for algo in MESH_ALGOS:
        w = want[algo]
        for rank, res in enumerate(ranks):
            got = res[algo]
            check([r["mask"] for r in got["rounds"]]
                  == [r["mask"] for r in w["rounds"]]
                  and [r["loss"] for r in got["rounds"]]
                  == [r["loss"] for r in w["rounds"]],
                  f"24b {algo} rank {rank}: masks or losses differ from "
                  f"shards:2's: {[r['loss'] for r in got['rounds']]} vs "
                  f"{[r['loss'] for r in w['rounds']]}")
            check(got["theta"] == w["theta"],
                  f"24b {algo} rank {rank}: θ differs from shards:2's")
            check(got["grad_hat"] == [w["grad_hat"][rank]],
                  f"24b {algo} rank {rank}: its ĝ rows differ from "
                  f"shards:2's")
            check(got["shape"] == (2, shards[rank].shard_rows, 128),
                  f"24b {algo} rank {rank}: ĝ is {got['shape']}")
            key = lambda r: (r["what"], r["kind"], r["bytes"])
            pred = sorted(map(key, got["predicted"]))
            for k, r in enumerate(got["rounds"]):
                check(sorted(map(key, r["records"])) == pred,
                      f"24b {algo} rank {rank} round {k}: records "
                      f"{sorted(map(key, r['records']))} vs predicted {pred}")
            counted = collective_bytes(got["rounds"][0]["records"])
            check(counted.total_bytes
                  == collective_bytes(got["predicted"]).total_bytes,
                  f"24b {algo} rank {rank}: counted bytes differ")
            for n, per in MESH_LAUNCHES[algo].items():
                check(got["launches"].get(n, 0) == per * MESH_STEPS,
                      f"24b {algo} rank {rank}: {n} launched "
                      f"{got['launches'].get(n, 0)} times in {MESH_STEPS} "
                      f"rounds, want {per} a round")
            for n, v in got["launches"].items():
                launches[n] = launches.get(n, 0) + v
            per_round = {n: v // MESH_STEPS
                         for n, v in got["launches"].items() if v}
            mean = lambda rs: sum(r["ms"] for r in rs[1:]) / (len(rs) - 1)
            print(f"  24b {algo} rank {rank}: ĝ {got['shape']} of {rows} "
                  f"rows; masks {[r['mask'] for r in got['rounds']]} and "
                  f"losses equal to shards:2's, θ and ĝ rows bitwise | "
                  f"rounds 1-{MESH_STEPS - 1} mean {mean(got['rounds']):.1f}"
                  f" ms vs shards:2's {mean(w['rounds']):.1f} ms | counted "
                  f"{counted.total_bytes:.0f} B a round (staged "
                  f"{counted.staged_bytes:.0f} B) = predicted | launches a "
                  f"round {per_round} | peak {got['peak']:.2f} GB vs "
                  f"shards:2's {w['peak']:.2f} GB")
    print(f"  phase 24b: 2 ranks, {wall:.1f} s with their start")
    return launches


def phase24(torch, phase5_runs, launches, smi):
    """Phase 24: 24a's one NCCL rank and 24b's two gloo ranks on the host
    mesh; their launches into ``launches``."""
    t24 = time.perf_counter()
    p24 = mesh_one_phase(torch, phase5_runs)
    for k, v in mesh_two_phase(torch).items():
        p24[k] = p24.get(k, 0) + v
    for k, v in p24.items():
        launches[k] = launches.get(k, 0) + v
    print(f"  phase 24 launches: { {k: v for k, v in p24.items() if v} } "
          f"in {time.perf_counter() - t24:.1f} s on {smi}")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from the root "
              f"of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.configs import get_config
    from repro_torch.device import gpu_name_and_power_limit
    from repro_torch.fastpath import kernels
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.lag_trigger import lag_trigger as lt
    from repro_torch.kernels.rmsnorm import rmsnorm as rms

    t_start = time.perf_counter()

    def say(*a, **kw):
        """A phase's header, after the seconds since the start."""
        print(f"({time.perf_counter() - t_start:.0f} s)", *a, **kw)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    name = torch.cuda.get_device_name(0)
    smi = gpu_name_and_power_limit()
    print(f"[1] device: {name} | count {torch.cuda.device_count()} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    t0 = time.perf_counter()
    libs = [kernels.LIBRARY, rms.LIBRARY, fa.LIBRARY, fa.LIBRARY_BF16,
            fa.LIBRARY_F16, lt.LIBRARY]
    build.build(libs)                  # one nvcc per source, all at once
    for lib in libs:
        build.load(lib)
    print(f"[2] built {len(libs)} libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    for lib in libs:
        log = build.BUILD_LOG.get(lib.name, {})
        print(f"  {lib.source.name}: {log.get('seconds', '?')} s: "
              f"{log.get('cmd', '(cached)')}")
        for line in log.get("ptxas", "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"    {line.strip()}")
            elif lib in (fa.LIBRARY_BF16, fa.LIBRARY_F16, rms.LIBRARY) and \
                    "entry function" in line:
                print(f"    {line.strip()[:140]}")
    flash_log = build.BUILD_LOG.get(fa.LIBRARY.name, {}).get("ptxas", "")
    spills = [line.strip() for line in flash_log.splitlines()
              if "spill" in line]
    bf16_log = build.BUILD_LOG.get(fa.LIBRARY_BF16.name, {}).get("ptxas", "")
    bf16_spills = [line.strip() for line in bf16_log.splitlines()
                   if "spill" in line]
    print(f"  flash_attention: {fa.SHARED_BYTES} (float32), "
          f"{fa.SHARED_BYTES_BF16} (bfloat16) bytes of dynamic shared memory"
          f" a block | float32 {spills or '(cached build: no ptxas report)'}"
          f" | bfloat16 {bf16_spills or '(cached build)'}")
    check(all(" 0 bytes spill stores, 0 bytes spill loads" in line
              for line in spills), f"the flash kernel spills: {spills}")
    check(not spills or len(spills) == len(fa.HEAD_DIMS)
          + len(fa.WIDE_HEAD_DIMS),
          f"want one ptxas report per float32 flash instantiation "
          f"{fa.HEAD_DIMS} and wide {fa.WIDE_HEAD_DIMS}: {spills}")
    for lib in (fa.LIBRARY_BF16, fa.LIBRARY_F16):
        sass = sass_of(lib.path())
        hgmma = sass.count("HGMMA")
        print(f"  {lib.name} ({lib.source.name}): {hgmma} HGMMA (wgmma) and "
              f"{sass.count('HMMA')} HMMA (mma.sync) instructions in its "
              f"SASS")
        check(hgmma > 0, f"the {lib.name} kernel has no wgmma")
    # the wide kernels (head_dim above 256) on the tensor cores: each
    # instantiation's own SASS, wgmma in 2-byte, mma.sync in float32
    for lib, op in ((fa.LIBRARY, "HMMA"), (fa.LIBRARY_BF16, "HGMMA"),
                    (fa.LIBRARY_F16, "HGMMA")):
        funcs = [f for f in sass_of(lib.path()).split("Function : ")[1:]
                 if "flash_wide_kernel" in f.split("\n", 1)[0]]
        counts = [(f.count(op), f.count("FFMA")) for f in funcs]
        print(f"  {lib.name} wide kernel: (tensor-core {op}, FFMA) "
              f"instructions per instantiation {counts}")
        check(len(funcs) == len(fa.WIDE_HEAD_DIMS)
              and all(n > 0 for n, _ in counts),
              f"the {lib.name} wide kernel is not on the tensor cores: "
              f"{counts}")
    # the float16 kernel's products stay asynchronous: where ptxas cannot
    # prove a wgmma's registers untouched until its wait, it waits after
    # every wgmma (as many WARPGROUP.DEPBAR as HGMMA)
    funcs = [f for f in sass_of(fa.LIBRARY_F16.path()).split(
        "Function : ")[1:] if "flash_f16_kernel" in f.split("\n", 1)[0]]
    counts = [(f.count("HGMMA"), f.count("WARPGROUP.DEPBAR"))
              for f in funcs]
    print(f"  {fa.LIBRARY_F16.name} flash_f16_kernel: (HGMMA, wgmma waits) "
          f"per instantiation {counts}; {fa.SHARED_BYTES_F16} bytes of "
          f"dynamic shared memory a block")
    check(len(funcs) == len(fa.INSTANCES_F16)
          and all(0 < 4 * w <= n for n, w in counts),
          f"the float16 flash kernel's wgmmas are serialized: {counts}")
    # 12c's data and 13d's CPU run, made beside phases 3-13
    gisette, fleet = cpu_child(GISETTE_CHILD), cpu_child(FLEET_CHILD)

    say("[3] kernels vs plain versions, ragged layouts", flush=True)
    ragged_phase(torch, dev)
    say("[4] kernels vs plain versions at the main path's shapes",
          flush=True)
    full = full_shape_phase(torch, dev)

    say("[5] main path: llama3.2-1b full width, W=2, batch 4, seq 256",
          flush=True)
    # the kernels each policy's fast route must launch every round
    want = {"lag-wk": ("delta_sqnorm_blocks", "masked_combine"),
            "laq@4": ("absmax_blocks", "laq_encode_blocks", "masked_combine")}
    launches = {k: 0 for k in kernels.LAUNCHES}
    phase5, phase5_runs = {}, {}
    for algo, names in want.items():
        run = trainer_phase(torch, algo, digest_after=DEVICES_STEPS)
        got = run["plane"]
        phase5[algo], phase5_runs[algo] = run["rounds"], run
        for k in names:
            check(got[k] >= 4, f"{algo}: kernel {k} launched {got[k]} times "
                               f"in 4 rounds")
        for k, v in got.items():
            launches[k] += v
    for k in kernels.ENTRIES:              # the float32 instantiations
        if k in OFF_PATH:
            print(f"  {k}: {launches[k]} launches, exempt: {OFF_PATH[k]}")
            continue
        check(launches[k] > 0, f"kernel {k} never launched on the main path")

    say("[6] GPU vs CPU on the reduced model", flush=True)
    small_agreement_phase(torch, dev)

    say("[7] model kernels vs plain versions, ragged and full shapes",
          flush=True)
    full.update(model_kernel_phase(torch, dev))
    say("[8] serving path: llama3.2-1b full width, batch 4, prompt 2048, "
          "32 tokens", flush=True)
    serve_launches, _ = serve_phase(torch, dev)
    launches.update(serve_launches)
    for k in serve_launches:
        check(launches[k] > 0, f"kernel {k} never launched on the serving "
                               f"path")

    say("[9] legacy per-leaf kernels vs plain versions, ragged and full "
          "shapes", flush=True)
    full.update(legacy_kernel_phase(torch, dev))
    say("[10] legacy per-leaf route (use_pallas_comm=True): llama3.2-1b "
          "full width, W=2, batch 4, seq 256", flush=True)
    legacy_launches = legacy_route_phase(torch, phase5)
    launches.update(legacy_launches)
    for k, v in legacy_launches.items():
        if k in LEGACY_BF16 + LEGACY_F16:     # 2-byte: phases 20, 22
            continue
        if k in OFF_PATH:
            print(f"  {k}: {v} launches, exempt: {OFF_PATH[k]}")
            continue
        check(v > 0, f"kernel {k} never launched on the legacy route")

    say("[11] lasg-wk, the schedules and the server steps: llama3.2-1b "
          "full width, W=2, batch 4, seq 256", flush=True)
    p11_plane, p11_legacy = policies_phase(torch)
    for k, v in {**p11_plane, **p11_legacy}.items():
        launches[k] += v
    print(f"  phase 11 launches: plane {p11_plane} | legacy {p11_legacy}")

    say("[12] the convex simulation: Fig. 3 float64 (a), the float32 "
          "plane (b), Gisette d=4837 (c), netsim pricing (d)", flush=True)
    convex_fig3_float64(torch, dev)
    convex_plane_kernels(torch, dev)
    p12 = convex_plane_float32(torch, dev)
    for k, v in p12.items():
        launches[k] += v
    print(f"  phase 12b launches: {p12}")
    convex_gisette(torch, dev, gisette)
    convex_cluster(torch, dev)

    say("[13] the deep topologies (a async, b pods), the fleet (c deep, d "
          "convex), the deep front door (e): llama3.2-1b full width, W=2, "
          "batch 4, seq 256", flush=True)
    p13 = phase13_deep(torch, phase5)
    small_topologies(torch, dev)
    convex_fleet_kernels(torch, dev)
    for part in (convex_fleet(torch, dev, fleet),
                 experiment_cluster(torch)):
        for k, v in part.items():
            p13[k] = p13.get(k, 0) + v
    for k, v in p13.items():
        launches[k] += v
    print(f"  phase 13 launches: { {k: v for k, v in p13.items() if v} }")

    say("[14] the gossip graph (a graph:2@ring full width, b "
          "Experiment(model=) graph:4@ring, c convex), resume (d)",
          flush=True)
    p14 = graph_full_width(torch)
    for part in (graph_experiment(torch, dev), graph_convex(torch, dev)):
        for k, v in part.items():
            p14[k] = p14.get(k, 0) + v
    graph_resume(torch)
    for k, v in p14.items():
        launches[k] += v
    print(f"  phase 14 launches: { {k: v for k, v in p14.items() if v} }")

    say("[15] the dense block kind: a the kernels at the new shapes, b "
          "serving five archs, c hubert-xlarge's forward, d training hubert "
          "and qwen2-vl, e the six reduced archs card = CPU", flush=True)
    t15 = time.perf_counter()
    wide_kernel_phase(torch, dev)
    p15 = dense_kind_serve(torch, dev)
    for part in (hubert_forward(torch, dev), dense_kind_training(torch)):
        for k, v in part.items():
            p15[k] = p15.get(k, 0) + v
    reduced_agreement(torch, dev, [get_config(a).reduced()
                                   for a in DENSE_KIND])
    for k, v in p15.items():
        launches[k] += v
    print(f"  phase 15 launches: { {k: v for k, v in p15.items() if v} } "
          f"in {time.perf_counter() - t15:.1f} s")

    say("[16] the recurrent and state-space kinds: a flash at head_dim "
          "256, b serving recurrentgemma-9b and mamba2-370m, c training "
          "them, d the reduced pair card = CPU", flush=True)
    t16 = time.perf_counter()
    hd256_kernel_phase(torch, dev)
    p16 = recurrent_serve(torch, dev)
    for k, v in recurrent_training(torch).items():
        p16[k] = p16.get(k, 0) + v
    reduced_agreement(torch, dev, [
        get_config("recurrentgemma-9b").reduced(num_layers=8),
        get_config("mamba2-370m").reduced()])
    for k, v in p16.items():
        launches[k] += v
    check(p16["flash_attention"] > 0 and p16["rmsnorm"] > 0,
          f"phase 16 launches {p16}")
    print(f"  phase 16 launches: { {k: v for k, v in p16.items() if v} } "
          f"in {time.perf_counter() - t16:.1f} s")

    say("[17] the moe kind: a flash at GQA 32/4 and 64/4, b serving "
          "qwen3-moe-30b-a3b (24 layers) and qwen3-moe-235b-a22b (5 layers), "
          "c training qwen3-moe-30b-a3b, d the reduced pair card = CPU",
          flush=True)
    t17 = time.perf_counter()
    moe_kernel_phase(torch, dev)
    p17 = moe_serve(torch, dev)
    for k, v in moe_training(torch).items():
        p17[k] = p17.get(k, 0) + v
    moe_small_agreement(torch, dev)
    for k, v in p17.items():
        launches[k] += v
    check(p17["flash_attention"] > 0 and p17["rmsnorm"] > 0,
          f"phase 17 launches {p17}")
    print(f"  phase 17 launches: { {k: v for k, v in p17.items() if v} } "
          f"in {time.perf_counter() - t17:.1f} s")

    say("[18] bfloat16 serving: a both kernels at bfloat16, b serving "
          "llama3.2-1b, command-r-35b (40 layers), qwen3-moe-30b-a3b (48), "
          "qwen3-moe-235b-a22b (reckoned), recurrentgemma-9b, hubert-xlarge's"
          " forward, c remat, d the reduced configs card = CPU", flush=True)
    t18 = time.perf_counter()
    full.update(bf16_kernel_phase(torch, dev))
    p18 = bf16_serve(torch, dev)
    for part in (remat_phase(torch, phase5_runs),):
        for k, v in part.items():
            p18[k] = p18.get(k, 0) + v
    bf16_small_agreement(torch, dev)
    for k, v in p18.items():
        launches[k] = launches.get(k, 0) + v
    check(p18["rmsnorm_bf16"] > 0 and p18["flash_attention_bf16"] > 0,
          f"phase 18 launches {p18}")
    print(f"  phase 18 launches: { {k: v for k, v in p18.items() if v} } "
          f"in {time.perf_counter() - t18:.1f} s")

    say("[19] bfloat16 training on the comm plane: a kernels 1-4 at "
          "bfloat16 operands, b llama3.2-1b at bfloat16 and with bfloat16 "
          "ĝ, c command-r-35b at the dry-run's depth, d reckoned vs "
          "measured peaks", flush=True)
    t19 = time.perf_counter()
    full.update(bf16_plane_kernel_phase(torch, dev))
    p19, masks19, runs19 = bf16_training_phase(torch, phase5_runs)
    for k, v in p19.items():
        launches[k] = launches.get(k, 0) + v
    for k in kernels.LAUNCHES:
        if k.endswith(("_bb", "_fb")):
            check(p19.get(k, 0) > 0, f"phase 19: {k} never launched")
    print(f"  phase 19 launches: { {k: v for k, v in p19.items() if v} } "
          f"in {time.perf_counter() - t19:.1f} s")

    say("[20] bfloat16 training of the mixed trees and the legacy route "
          "at bfloat16: a the legacy kernels' bfloat16 instantiations, b "
          "mamba2-370m, qwen3-moe-30b-a3b, recurrentgemma-9b and "
          "qwen3-moe-235b-a22b on the plane, the legacy and the plain route, "
          "c llama3.2-1b on the legacy route", flush=True)
    t20 = time.perf_counter()
    full.update(legacy_bf16_kernel_phase(torch, dev))
    p20 = mixed_training_phase(torch)
    for k, v in legacy_bf16_route_phase(torch, masks19).items():
        p20[k] = p20.get(k, 0) + v
    for k, v in p20.items():
        launches[k] = launches.get(k, 0) + v
    for k in LEGACY_BF16:
        if k in OFF_PATH:
            print(f"  {k}: {launches.get(k, 0)} launches, exempt: "
                  f"{OFF_PATH[k]}")
            continue
        check(p20.get(k, 0) > 0, f"phase 20: {k} never launched")
    for k in ("delta_sqnorm_blocks_bb", "delta_sqnorm_blocks",
              "masked_combine_bb", "masked_combine"):
        check(p20.get(k, 0) > 0, f"phase 20: the plane's {k} never "
                                 f"launched on a mixed tree")
    print(f"  phase 20 launches: { {k: v for k, v in p20.items() if v} } "
          f"in {time.perf_counter() - t20:.1f} s")

    say("[21] bfloat16 training on the topologies: llama3.2-1b on "
          "async:2@1, pods:2, fleet:4@2, fleet:2@1, fleet:2@2; mamba2-370m "
          "on pods:2, async:2@1 (checkpointed and resumed), fleet:4@2",
          flush=True)
    t21 = time.perf_counter()
    p21 = bf16_topology_phase(torch, runs19)
    for k, v in p21.items():
        launches[k] = launches.get(k, 0) + v
    for k in sorted({k for *_, want, _ in PHASE21 for k in want}):
        check(p21.get(k, 0) > 0, f"phase 21: {k} never launched")
    print(f"  phase 21 launches: { {k: v for k, v in p21.items() if v} } "
          f"in {time.perf_counter() - t21:.1f} s")

    say("[22] float16: a kernels 1-12 at float16, the rows RMSNorm kernel "
          "and the wide flash kernel in all three dtypes, b serving "
          "llama3.2-1b float16, c training llama3.2-1b and mamba2-370m at "
          "float16 (plane, legacy, plain; pods:2, fleet:2@2)", flush=True)
    phase22(torch, dev, full, launches)

    say("[23] the device plane: a the wire format at full width, b "
        "devices:1 over nccl vs shards:1, c devices:2 over gloo (two ranks "
        "sharing the card) vs phase 5's shards:2", flush=True)
    phase23(torch, dev, phase5_runs, launches, smi)

    say("[24] the host mesh (--mesh host): a one NCCL rank vs phase 5, b "
        "two gloo ranks sharing the card (llama3.2-1b at 2 layers) vs "
        "shards:2", flush=True)
    phase24(torch, phase5_runs, launches, smi)

    rows = [dict(name=k, route="cuda", source=SOURCES.get(k, SOURCE),
                 replaces=REPLACES[k], launches=launches.get(k, 0),
                 **full[k])
            for k in REPLACES]
    print(json.dumps({"kernels": rows}))
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        stop_children()
