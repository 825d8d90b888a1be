#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Every solve below runs as the port's users run it: on the card a solver
captures its outer loop as a CUDA graph at its first solve of a shape and
replays it for every later solve of that shape (``mpc_mmd_tpu_torch/
graph.py``); only the exact strategy and the two-rank candidate split (13d)
run eagerly.  A replay adds to the kernel wrappers' launch counts what its
capture counted, so every exact launch check below holds for replays too.

Phases, each of which must pass:

1. the card: name and power limit (nvidia-smi);
2. builds the CUDA kernels from ``mpc_mmd_tpu_torch/csrc`` (nvcc, sm_90a);
3. each kernel against its plain PyTorch twin on the card, with CUDA-event
   times of both:
   K1 top-k indices equal exactly at every shape a solve path launches it
   with (``launch_shapes``: every selection runs as a form of kernel (c),
   so no path launches K1, K2, K2t or K3; they are checked at the shapes
   where the forms' chains, their plain versions, launch them): the "xt"
   and "g" selections' fastrt (64, 57, 101), k = 10,
   "xt"'s iteration-0 batch (1, 64, 101), "g"'s (64, 64, 101), and the
   elite pick (64, 64), k = 7; the same on Path A, (100, 89, 101), (1,
   100, 101) and (100, 100, 101), and Path D, (100, 89, 17), (1, 100, 17)
   and (100, 100, 17), k = 4; the fused selection's elite pick (100, 100),
   k = 11, and at Path A's chunk of 4, (400, 100); Path F's), each with an
   all-NaN row, NaN lanes, ties, -0.0 against +0.0, +-inf and fewer finite
   lanes than k;
   K2 QP within rtol 1e-4 + atol 1e-5 of the twin run in float64 at every
   path's number and size of systems (the "g" and "fused" selections'
   3,648, 4,096, 8,900, 10,000 of n = 10; Path D's 8,900 and 10,000 of n =
   4; Path F's 10,000 of n = 5 and 15; Path E's fused chunk, 40,000 of n =
   10);
   K2's lane-major entry (the "xt" selection's) the same way at 3,648,
   4,096, 8,900 and 10,000 systems of n = 10 and 8,900 and 10,000 of
   n = 4, and against K2's row-major kernel on the same systems (one
   body: the gap is logged, 0.0 when the bits are equal);
   K4 rollout within atol 1e-4 at the fastrt solve's shape, at Path D's
   (1,600 lanes x 50 steps from a state per lane in ``mmd_opt``, 400 in
   ``cvar``, ``saa`` and ``mmd_random``), at Path E's chunks (25,600,
   51,200, 40,000 and 4,000 lanes), and at the Monte-Carlo validator's
   (256 solves x 1000 rollouts x 50 steps);
   K3 fused selection at the dynamic workload's shape (100, 100, 101) and
   at the fastrt shape (64, 64, 101), k = 10, at Path D's (100, 100,
   17), k = 4, and at Path E's chunk of 4 Path A scenarios (400, 100,
   101), k = 10, rows with a NaN lane and tied |beta| included: indices
   equal exactly, row sums and K_red within rtol 1e-5 + atol 1e-6;
   K5 one-hot top-k at (64, 57, 101), k = 10: indices and one-hot rows
   equal exactly;
   kernel (c), the whole inner beta-CEM (``ops.inner_cem``) in the form of
   each (selection, elite-carry) pair, against its plain version
   (``inner_cem_plain``: the pair's chain of K1, K2, K2t, K3 and
   PyTorch's operations, on the card) from the same inputs at every shape
   and form a path launches it with (``launch_shapes``: "xla" at fastrt's
   64 candidates, 64 samples, M = 100, k = 10, 12 iterations, Path E's
   chunks of 4 and 8 (256 and 512 candidates), Path A's 100 x 100, M =
   100, 20 iterations, Path D's 100 x 100, M = 16, k = 4, Path F's M = 25
   and 225; without elite-carry at fastrt's; "fused" at Path A, its chunk
   of 4 (400 candidates), Path D, F5 and F15; "xt" at fastrt, Path A, Path
   D, F5 and F15; "g" at fastrt, Path A, Path D and F15), "xla" also at
   fastrt's with the gaussian and matern52 kernels, at 11a's chunk of 32
   (2,048 candidates) and without elite-carry at F15 (its elites run
   again), a NaN lane and tied |beta| in the first batch (and an infinite
   lane for "fused"): "xla" with elite-carry at one iteration the winners'
   indices equal exactly and their weights, bandwidths and costs within
   rtol 1e-5 + atol 1e-6, at the path's iterations every candidate's costs
   within rtol 1e-4 + atol 1e-6, at most 2 % of a shape's candidates apart
   (each logged with the first iteration apart); every other form bit for
   bit in every output of every candidate at one iteration and the path's,
   and "fused" at the chunk of 4 also against each scenario's 100
   candidates alone; how many candidates are bit-equal is logged;
   kernel (d), the outer iteration's guess QP, AM projection and controls
   (``ops.outer_project``, ``csrc/outer_project.cu``), against its plain
   version (``outer_project_plain``) from the same inputs
   (``kernel_ab.kd_inputs``: a row past v_max, the carried state of an
   iteration before, on the road a path) at every shape and form a path
   launches it with (``outer_shapes``: fastrt, E4, E8, Path A and Path B's
   modes, Path D and its other modes, F5, F15; the obstacle-active form at
   Path D ``det``), at 11a's chunk of 32 and the obstacle-active form at a
   straight 64-row solve with 6 obstacles: every output bit-equal; at the
   first shape, the chunk of 32 and each obstacle-active shape one and two
   rows a CTA and the run-time-shape instantiation bit-equal to the launch
   the wrapper picks; the run-time-shape instantiation at num 60 within
   rtol 1e-5 + atol 1e-6, its bit-equal entries logged; kernel (e), the
   outer iteration's tail in each risk form (risk, sorts, lane risks,
   cost, CEM update; ``ops.outer_tail``, ``csrc/outer_tail.cu``), against
   ``outer_tail_plain`` from ``kernel_ab.ke_inputs`` (a tie in risk and in
   cost, a rollout with a NaN, a candidate without a violation) at its
   path shapes and forms (``mmd_opt`` at fastrt, E4, E8, Path A, Path D,
   F5, F15; Path B's ``cvar``, ``saa``, ``mmd_random``; EB4's ``cvar``;
   Path D's ``cvar``, ``saa``, ``mmd_random``, ``det``), 11a's chunk of 32
   and once with a covariance that is not positive definite: the kept,
   the elites and the pick equal (or each difference a near-tie of the
   plain version's risks within 1e-6), the moments, parameters, risks, res
   and res_2 bit-equal at the path shapes; at the first shape of each form
   every cluster size bit-equal to the picked one, with every CTA of a
   cluster keeping the same candidates;
   K4n, K4's noisy-controls entry (``ops.noisy_rollout``), kernel (f), the
   refit and distance matrices before the inner CEM
   (``ops.inner_prologue``, ``csrc/inner_prologue.cu``), and kernel (g),
   the on-road rollouts' Frenet points (``ops.frenet_points``,
   ``csrc/frenet_points.cu``), against their plain versions
   (``noisy_rollout_plain``: perturb_controls, the pairing and K4;
   ``inner_prologue_plain``: the refit's cuBLAS products, pairwise_l1 and
   pairwise_l2sq; ``global_to_frenet_points``) at every shape a path
   launches them with (``glue_shapes``), K4n also with const noise, (f)
   also with the gaussian and matern52 kernels, (g) also at a chunk of 4,
   with edge points and a NaN, on ``kernel_ab.kg_case``'s adversarial
   inputs (ties across tiles, non-finite points and path points, squares
   that overflow, duplicate path points, ragged sizes, points at a circular
   path's centre, every point NaN) and on a closed-loop frame
   (``kernel_ab.kg_closedloop``: local_problem's frame 150 m along the
   curved route): every output bit-equal, and (g)'s nearest indices and
   visited tiles (each wrapper's ``probe`` launch) its twin's
   (``nearest_pruned``), the tiles visited a point logged; (g)'s state
   form (``ops.frenet_states``: the noisy initial states and boundary
   rows) against ``frenet.initial_states`` at every on-road mode's number
   of states (16, 4, 1) and at 100 and 256 on the closed-loop frame and
   adversarial ones, and its obstacle form (``ops.frenet_obstacles``)
   against ``global_to_frenet_obstacle`` at the closed loop's obstacles
   and adversarial ones: every output bit-equal, the indices and visited
   tiles the twin's, and with the horizon's times (as ``local_problem``
   launches it) its trajectories bit-equal to
   ``constant_velocity_obstacles``; kernel (h), the closed loop's local
   path in one launch (``ops.local_frame``, ``csrc/local_frame.cu``),
   against its chain (``frenet.smooth_path`` then ``path_parameters``)
   and its twin (``local_frame_twin``) on ``kernel_ab.kh_window``'s
   windows (three routes near three points, num_path 600 and 64, one and
   ten rounds), windows with a NaN waypoint and the closed loop's window:
   every output bit-equal, NaN to NaN;
   then the launch floor (the device time of ``fill_`` on one float) and,
   for each kernel at the shapes above (K1 and K2 at every path shape, K3
   and K4 at each timed one), its own device time per launch from
   ``torch.profiler`` (kernels (d) and (e) also L2-cold: a 64 MB buffer
   written before each launch), its
   bound, and the device time of the one PyTorch call that computes the
   same function, where there is one (``torch.topk`` for K1,
   ``torch.linalg.solve`` of the bordered KKT system for K2,
   ``torch.cdist(p=1)`` of the features for kernel (f)'s D; the port
   never calls any; none for K3, K4, K4n, K5 and kernels (c), (d), (e),
   (g)); K4n and kernels (f) and (g) also L2-cold, (g) also where every
   warp visits every tile;
4. the full-width fastrt ``mmd_opt`` solve (64 candidates x 10 iterations,
   100 mother rollouts, inner CEM 64 samples x 12 iterations): one warm-up
   solve, then 3 scenarios, each with finite coefficients and risk and
   sum(beta) = 1 within 1e-3, with kernel (c) (one launch an outer
   iteration), kernel (f) and K4n launched;
5. one outer iteration on the card against the same on the CPU with
   identical draws: the controls of the returned coefficients within 1e-3
   (the JAX package's parity bar) and the coefficients within 1e-3 of
   their scale;
6. Path A, the dynamic cut-in workload in ``mmd_opt`` with the fused
   selection (``MPC_MMD_FUSED_CEM=1``) at full width: 100 candidates x 20
   iterations, 100 mother rollouts, inner CEM 100 samples x 20 iterations,
   Beta noise 0.2; one warm-up solve, then 2 cut-in scenarios of
   ``scenarios.dynamic_cutin``, each checked as in 4, with exactly
   maxiter_cem launches each of kernel (c)'s fused form, K4n and kernel
   (f) per solve and none of K1, K2 and K3 (``inner_launches``); one more
   fused solve under ``torch.profiler`` (device busy ms, idle share, the
   fused form's device ms per solve); then 2 solves with the default
   "xla" selection (kernel (c)) at the same width;
7. Path B, the same workload in ``cvar`` (one warm-up, 2 solves), then one
   solve each of ``mmd_random`` and ``saa``: finite, with exactly one
   launch each of kernels (d) and (e) and K4n an outer iteration and the
   draws (``loop_launches``);
8. one outer iteration of Path A on the card against the CPU with
   identical draws (the CPU run records its Beta draws, the card replays
   them), held as in 5;
9. Path C, the researcher's pipeline through ``mpc_mmd_tpu_torch.cli``:
   a. the sweep CLI over 40 static scenarios (gaussian 0.1, N = 10, 6
      obstacles, ts 50, fastrt budgets) in ``mmd_opt`` and ``cvar``, chunks
      of 20, ``pipeline`` dispatch, into a temporary directory;
   b. the same command again, which must solve nothing (every chunk
      resumes);
   c. ``validate_compare`` of the two stores at n_mc = 1000;
   d. a dynamic cut-in ``cvar`` sweep of 20 scenarios (Beta 0.2) and its
      validation at n_mc = 1000;
   e. the validator alone over 1200 solves (the stored ones repeated) at
      n_mc = 1000: time and peak memory, then once more under
      ``torch.profiler``: device busy time, idle share, device events and
      K4's device time;
   f. the validator on the card against the CPU on 8 stored solves with
      identical draws: counts within +-1 per solve, mean collision % within
      0.1 pp;
   g. one fastrt ``mmd_opt`` solve with the gaussian and one with the
      matern52 MMD kernel: finite, with kernels (c) and (f) and K4n
      launched.
   Each of a-e and g runs with the launch counts set to 0 just before it
   and read just after; a, c, d, e and g fail unless their kernels were
   launched, b if any kernel was;
10. Path D, the on-road stack at full width: ``onroad_workload(num_reduced
   =4, num_obs=4, num_prime=50)``, gaussian 0.1, 100 candidates x 20
   iterations, 16 mother rollouts from 16 noisy initial states, inner CEM
   100 x 20; the frame of step 0 of a curved-route episode built on the
   card as ``run_episode`` builds it (waypoint window, smoothing, path
   parameters, obstacles in Frenet):
   a. (in phase 3) K1, K2, K3, K4 and kernel (c) at its shapes;
   b. ``FrenetSolver`` in ``mmd_opt`` with the "xla" selection: one
      warm-up solve, then 2 solves with finite cx, cy, v_best and
      steering_best and exactly 20 launches each of kernels (c), (d), (e),
      K4n and kernels (f) and (g) (no K1, no K2, no K4) and one of (g)'s
      state form, and one more under ``torch.profiler`` (device busy, idle
      share);
   c. one solve with ``MPC_MMD_FUSED_CEM=1``: exactly 20 each of kernel
      (c)'s fused form, K4n and kernels (f) and (g), no K1, K2 or K3;
   d. one solve each of ``cvar``, ``saa``, ``mmd_random`` (20 launches
      each of K4n, kernels (g), (d) and (e), no K4) and ``det`` (no
      rollout: 20 each of (d)'s obstacle-active form and (e)'s ``det``
      form); each one launch of (g)'s state form;
   e. one outer iteration of ``mmd_opt`` on the card against the CPU with
      identical draws: seed 1's, v_best and steering_best within 1e-3;
      and seed 5's, whose inner CEM meets a near-tie that round-off
      decides (ROADMAP Queue 3), logged and not held;
   f. the closed-loop CLI, ``python -m mpc_mmd_tpu_torch.cli.closedloop
      --route curved --episodes 1 --max_steps 20``, in ``mmd_opt``, ``cvar``
      and ``det``, run in this process: each prints its episode line and
      launches one (d) and one (e) an outer iteration of every step, the
      first two their other kernels, and one each of (g)'s state and
      obstacle forms and of (h) a step, ``det`` nothing else but the
      draws; each step's ``local_problem`` runs under an ATen counter
      and must run no ``mv``, ``addmv`` or ``cumsum`` (its operations a
      step logged);
   g. ``local_problem``'s host ms a step (to ``torch.cuda.synchronize``)
      with its frame from (h) and from the chain (``smooth_path``,
      ``path_parameters``) on the card, in turns, and the closed-loop step
      a vehicle stack waits for (``local_problem``, then the ``det`` and
      the ``mmd_opt`` solve) the same way; logged with the ATen
      operations of ``local_problem`` either way.
   Each of b-d and f runs with the launch counts set to 0 just before it
   and read just after.
11. Path E, scenario chunks (``Solver(cfg, scenario_chunk=N).solve_batch``:
   one outer loop over N scenarios, each kernel launched once for the
   chunk) and the exact strategy:
   a. fastrt ``mmd_opt`` (as in 4) over 8 static scenarios at chunks of
      1, 4 and 8, one warm-up chunk each: solves/s, peak memory, and
      launches per chunk, which must equal one solve's exactly; and every
      scenario's cx, cy, risk_obs, res and CEM moments at chunks 4 and 8
      bit-equal to chunk 1's (these scenarios meet near-ties that
      round-off decides, so any change of summation order shows); then
      one chunk of 32 static scenarios, its first, a middle and its last
      scenario's same fields bit-equal to each solved alone;
   b. a chunk of 4 tie-free blocking scenarios against each scenario
      solved alone on the card, on the same draws: cx, cy and risk_obs
      within 1e-4 of their scale;
   c. Path A fused at chunk 4 over 4 cut-in scenarios: exactly 20 each of
      kernel (c)'s fused form, K4n and kernel (f) per chunk, no K1, K2 or
      K3;
   d. Path B ``cvar`` at chunk 4: exactly 20 launches each of K4n and
      kernels (d) and (e) per chunk;
   e. the sweep CLI over Path C's 40 static scenarios in ``mmd_opt`` with
      ``--dispatch batch --chunk 8 --scenario_chunk 4``, against Path C's
      ``--dispatch pipeline`` store: the same seeds accepted, cx and cy
      within 1e-4 of their scale; both solves/s;
   f. one fastrt ``mmd_opt`` solve and one Path D ``mmd_opt``
      ``FrenetSolver`` solve with ``solve_strategy="exact"`` under CUDA's
      sync debug mode at "error" (no host sync): finite, with exactly
      maxiter_cem K4 launches and nothing else;
   g. one outer iteration of fastrt exact on the card against the CPU with
      identical draws, held as in 5.
   Each of a, c-f runs with the launch counts set to 0 just before it and
   read just after.
12. the "xt" and "g" selections (``MPC_MMD_SELECTION``) and "xla" without
   elite-carry (``MPC_MMD_ELITE_CARRY=0``): one warm-up and one counted
   solve each of fastrt, Path A and Path D (``FrenetSolver``; fastrt alone
   without elite-carry), finite, with exactly maxiter_cem launches of
   kernel (c) in the pair's form and none of K1, K2 and K2t, and
   maxiter_cem of K4n; then one outer iteration of each on the card
   against the CPU with identical draws, held as in 5 (Path D on seed 1's
   draws);
13. the distribution layer (``parallel/mesh.py``):
   a. a one-rank NCCL group in this process: ``sharded_sweep`` over 8
      fastrt scenarios, bit-equal to ``solve_batch`` with 8 solves'
      launches, and ``hosts_alive`` (an NCCL all_reduce);
   b. ``python -m torch.distributed.run --nproc_per_node 2`` of this
      script's ``--rank`` mode, two gloo ranks on the one card: the sweep
      CLI ``--dispatch mesh --chunk 8 --scenario_chunk 4 --heartbeat_every
      1`` over Path C's 40 scenarios, whose merged store (a manifest per
      rank, every chunk once) must equal 11e's batch store bit for bit,
      with one solve's launches per chunk; solves/s logged, no claim;
   c. in the same ranks ``validate --mesh`` on that store at n_mc = 1000:
      counts equal to ``validate_store`` in this process;
   d. in the same ranks one fastrt solve with its candidates split over
      the two ranks (``Solver(..., candidate_mesh=...)``) against the
      plain solve on the blocking scenario: res within 1e-5 and cx, cy
      within 1e-4 of their scale; each rank makes one solve's launches;
   e. ``python -m mpc_mmd_tpu_torch.cli.prewarm --presets fastrt --modes
      mmd_opt cvar`` in this process: its JSON lines, kernel (c) and K4n
      launched.
   Each of 12's solves and 13 a, e runs with the launch counts set to 0
   just before it and read just after; b-d read each rank's counts.
14. every reduced-set size N = num_reduced = 2 ... 16 (Path F: the JAX
   record's static acceptance cells, ``record_config``: Beta noise 0.3, 6
   obstacles, ts 50, 100 x 20 outer and inner, M = N^2 mother rollouts):
   a. K1 at (100, 89, N^2 + 1) and (1, 100, N^2 + 1), k = N, |x| of the
      first N^2 lanes, edge rows included, and K5 at the first, indices
      and one-hot rows equal to the twins; K2 at 8,900 and 10,000 systems
      of n = N within rtol 1e-4 + atol 1e-5 of the float64 twin, and its
      lane-major entry bit-equal to it; K3 at (100, 100, N^2 + 1), k = N,
      indices and K_red equal to the twin, row sums within rtol 1e-5 +
      atol 1e-6; for every N;
   b. at N = 5 and 15, under the "xla", "fused" and "xt" selections: one
      warm-up and 3 timed solves each, launches per solve exactly what
      ``launch_shapes`` (and phase 3's K3 and K4 shapes) give the path;
      then one outer iteration on the card against the CPU with identical
      draws, held as in 5; and one solve under "g" at N = 15 (kernel (c)'s
      form; its chain's blocked (C, S', M, M) exponential was 1.8 GB an
      inner iteration), its time and peak memory logged, launches as in
      12;
   c. the sweep CLI at ``--workload static --costs mmd_opt cvar --noises
      beta --noise_levels 0.3 --num_reduced_sets 5 15 --num_obs 6
      --num_prime 50 --num_configs 4``, each store's meta naming its N, and
      ``validate --compare --n_mc 1000`` on each N's pair of stores
      (acceptance counts and n_common logged, no claim);
   d. ``python -m mpc_mmd_tpu_torch.parallel --device cuda`` in a
      subprocess (the distribution layer's dryrun, K2 at n = 2): exit 0
      and ``dryrun ok``.
   Path F's shapes are in phase 3's checks and times: K1 (100, 89, 26) and
   (1, 100, 26), k = 5, and (100, 89, 226) and (1, 100, 226), k = 15; K2
   and its lane-major entry at 8,900 and 10,000 systems of n = 5 and 15;
   K3 (100, 100, 26), k = 5, and (100, 100, 226), k = 15; K4 at 2,500 and
   22,500 lanes.  b's solves and c's commands run with the launch counts
   set to 0 just before and read just after; a's launches are
   comparisons and are not counted.
15. the JAX key chain's draws: ``noise.JaxNoise``, the default noise of
   every path above, draws through kernel (a) ``ops.prng_draws`` (keys to
   bits, uniforms or normals), its plan form ``ops.prng_plan`` (a solve's
   every Gaussian draw in one launch, from its key table) and kernel (b)
   ``ops.prng_beta`` (Beta), CUDA source ``csrc/prng.cu``.  Every exact
   launch check above counts them too (``loop_launches``: one plan a
   solve or chunk, one Beta launch an outer iteration under Beta noise; a
   fresh solver's first solve adds the solver-fixed draws by
   ``prng_draws``; and kernels (d) and (e): one (d) an outer iteration on
   every path but "exact" and ``det``, one (e) in ``mmd_opt`` but under
   "exact" and the two-rank candidate split), and ``draw_shapes`` gives
   their shapes:
   a. kernel (a) against its twin at every segment shape of a path's plan
      (a solve's rollout noise, 3 keys a scenario of R x T normals an
      iteration; its resample, a key a scenario an iteration; a Frenet
      solve's initial states) and at the validator's chunks (768 and 528
      keys x 50,000: 256 solves x 1000 rollouts x 50 steps x 3 families):
      bits equal, uniforms and normals within 1 ulp (the twin's
      double-rounded fma); its plan form at every path's plan
      (``JaxNoise.plan`` on a key table of the path's chunk and
      iterations): each segment bit-equal to ``prng_draws`` of its keys,
      within 1 ulp of the twin;
   b. kernel (b) against its twin at Path A's Beta 0.2 shape (2 keys x 100
      candidates x 500), its chunk of 4, Path F's at N = 5 and 15, and a
      Beta validator chunk (512 keys x 50,000): within rtol 1e-5 + atol
      1e-6;
   c. both against ``jax.random``'s draws for fixed keys
      (``mpc_mmd_tpu_torch/data/prng_reference.npz``, the card has no
      JAX): bits and uniforms equal, normals within 4 ulp, Beta within
      rtol 1e-5 + atol 1e-6;
   d. the full-width fastrt ``mmd_opt`` solve of idx_mpc 5 on its default
      noise against the JAX package's solve stored in that file: a first
      solve captures the graph, the second, a replay bit-equal to it, is
      held: the controls within 1e-3, both runs' costs per outer iteration
      printed;
   e. the kernels' device time, bound and library call (``torch.randn``
      with a generator; ``torch._standard_gamma``), the plan form's beside
      the device time of the per-iteration draws it replaces at each plan,
      then the validator's time at 1200 x 1000 and the fastrt and Path A
      solve latencies on the new draws.
16. the solve as one CUDA graph, each solver graphed by default against
   one made with ``graph=False`` (eager) on the same inputs:
   a. bit for bit, with equal launch counts per call and every kernel of
      the path launched, every replay under CUDA's sync debug mode at
      "error", and every result kept unchanged to the end: three
      full-width fastrt solves (other seeds, scenarios, initial states and
      v_des; the first captures), the same under "xt", two ``solve_batch``
      calls of 7 scenarios at chunk 4 (a graph for the chunk of 4 and one
      for the short chunk of 3), three Path A fused solves with Beta noise
      (kernel (c)'s fused form), two Path A "xla"
      and two Path B ``cvar`` solves with Beta noise, and three Path D
      ``FrenetSolver`` steps of a moving plant (state, frame, obstacles,
      mean and v_des all changed) in ``mmd_opt`` and in ``det``; each
      graph's nodes, capture and instantiation seconds;
   b. eager against graphed in turns, host time to ``torch.cuda.synchronize``:
      p50 and p99 of 20 fastrt solves each and of 6 Path A fused and 6
      Path A "xla" solves each, solves/s of ``solve_batch`` over 8
      scenarios at chunks 4 and 8
      (median of 4 each), and the Path D closed-loop step (``run_episode``
      as the closed-loop CLI runs it, 2 episodes of 20 steps each), p50,
      p99 and mean against the 150 ms control period;
   c. one graphed fastrt, Path A fused, Path A "xla" and Path D solve
      each, a replay,
      under ``torch.profiler``: device busy ms, idle share, device events;
      and the busy time against the p50 of 5 untraced replays of the same
      solve.
   Its counts are set to 0 before each run of a and b and read after.

Prints phase 16's JSON record (``{"graph": ...}``), the kernels' JSON
record and the card's nvidia-smi line, and as the last line ``{"ok": true,
"device": {...}}``.  In the kernels' record, ``launches`` counts the
launches of the paths' runs (phases 4, 6, 7, 9 a-e, g, 10 b-d, f, 11 a,
c-f, 12, 13, 14 b-c and 16 a-b; kernel (c) on every path of every
selection, one launch an outer iteration, and its forms' rows
``inner_cem_fused``, ``inner_cem_xt`` and ``inner_cem_g`` those of their
form; K1, K2, K2t and K3 on none since kernel (c) took every selection:
their rows time them at the chains' shapes); K5 is on no path of the
package, and its count is that of its own phase.
Kernels (d) and (e) launch once an outer iteration wherever
``loop_launches`` routes them, and the shapes of ``outer_shapes`` add
up to every path's count (``check_launch_shapes``); so do K4n and
kernels (f) and (g) (``glue_shapes``), which replace K4 on every path
but the exact strategy's and the candidate split's (and the validator's,
which is K4's own).
``launches_per_solve`` splits them by path (per solve; per chunk on
Path E's chunked runs; the validator's per 1200 validations).  The
times, all in milliseconds at ``shape``:

- ``ms``: CUDA events around a Python loop of 50 wrapper calls, over 50.
  It includes the wrapper's host work (checks, ``torch.empty``, the
  ``ctypes`` call), which sets a floor of tens of microseconds: an upper
  bound on the kernel, not its time.
- ``plain_ms``: the same for the plain PyTorch twin.
- ``device_ms``: the kernel's own device time per launch, from
  ``torch.profiler`` over 20 launches.
- ``bound_ms``: the largest of the bytes (each input read once, each output
  written once) over 3.35 TB/s, the float32 operations over 67 TFLOP/s and
  the integer operations (the draw kernels' hashes) over 16.75 T/s, a
  quarter of the float32 rate (``bound_by`` says which: "operations" for
  either of the last two).  The Beta kernel's candidates share their key
  chains (the keys, the bits and the normals of a round depend only on
  the key, the element and the round), so its bound counts that work once
  a (key, element), over the rounds some candidate takes, and only the
  tests a candidate's own.  K2 needs only the lower triangle of each
  SPD system C: the lane-major entry, whose C rows lie apart, counts those
  n(n+1)/2 rows of B words; the row-major entry counts all of C, whose
  triangles share each 32-byte sector the card fetches.
- ``library_ms``: the device time per call of the library call named in
  ``library``, or null where no single call computes the function
  (``library`` then says so).

K4 also carries ``largest``: the same at the validator's 256,000 lanes.
K1, K2, K3 and K4 carry ``shapes``: for every path shape timed its device
time, bound, plain twin's time, library time and launches per solve per
path (for each path a shape names, the sum over the shapes must equal the
launches that path's run counted).  Every row carries
``launch_floor_ms``.
Exits non-zero, with no result, when there is no CUDA card or the package
is not beside it.
"""

import contextlib
import dataclasses
import glob
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TIMES = {}      # host seconds of the timed runs, by label, for phase 15's summary


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, reps=50, warmup=3):
    """Mean milliseconds per call, from CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
# H100 SXM 32-bit integer operations: 64 INT32 lanes an SM against 128
# float32 lanes, whose fused multiply-add counts twice in the 67 TFLOP/s
INT32_OPS_PER_S = FP32_OPS_PER_S / 4


# The critical path of one rollout step in clock64 cycles, measured in this
# run (``kernel_ab.step_cycles``: one lane's dependent chain of
# rollout.cu's step(), alone on its SM): K4n's (a_t and tan(s_t) formed
# before the chain) and K4's (tanf in it).  A lane's T steps of it at the
# card's highest SM clock are a latency bound that no block shape beats.
STEP_CYCLES = {}


def sm_clock_max_mhz():
    """The card's highest SM clock (nvidia-smi's clocks.max.sm), in MHz;
    NaN where nvidia-smi is missing (a rehearsal on the CPU)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True)
    except FileNotFoundError:
        return float("nan")
    return float(out.stdout.split()[0])


def bound(nbytes, ops, int_ops=0):
    """Least milliseconds the card could take: the largest of the bytes over
    the memory rate, the float32 operations over the float32 rate and the
    integer operations over the INT32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(ops / FP32_OPS_PER_S, int_ops / INT32_OPS_PER_S)
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def profiled_ms(torch, fn, reps=20, match=None, least=None):
    """Device milliseconds per call of ``fn`` from ``torch.profiler``.

    With ``match`` (a kernel's name), the device events whose name holds it
    are the kernel's launches, one a call, and their summed time over their
    number is the kernel's own device time per launch.  The profiler now and
    then records no device event in a session, or drops a launch's record:
    up to five sessions are tried for one that records all ``reps``; failing
    that, the fullest session is used if it recorded at least ``least`` of
    them (default half; never more than ``reps``: more would mean ``match``
    names another kernel too).  A library call's kernel is timed with
    ``least`` 1: its name is matched exactly, and the profiler has kept
    only 4 of 20 records of a 64-element ``torch.randn`` in five sessions.  Without ``match``, every device event of the window
    counts, over ``reps``: a library call's device time, whatever kernels
    it launches.  Each session opens with a short ``spin_kernel``, left out
    of the count, so that no launch under test is the session's first.
    Returns (ms, names seen).
    """
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    best = []
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(100)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "spin_kernel" not in e.name
              and (match is None or match in e.name)]
        names = sorted({e.name for e in ev})
        if match is not None and len(ev) > reps:
            fail(f"profiler: {len(ev)} device events named {match!r} for {reps} "
                 f"launches ({names})")
        if len(ev) > len(best):
            best = ev
        if ev and (match is None or len(ev) == reps):
            break
    names = sorted({e.name for e in best})
    least = reps / 2 if least is None else least
    if not best or (match is not None and len(best) < least):
        fail(f"profiler: at most {len(best)} device events named {match!r} for "
             f"{reps} launches in 5 sessions ({names})")
    if match is not None and len(best) < reps:
        log(f"profiler: {len(best)} of {reps} launches of {match!r} recorded in "
            f"the fullest of 5 sessions; the time is per recorded launch")
    per = len(best) if match is not None else reps
    return sum(e.time_range.elapsed_us() for e in best) / 1e3 / per, names


def f32_bytes(*tensors):
    return sum(4 * t.numel() for t in tensors)


def launch_shapes(paths):
    """K1's, K2's, K2t's, K3's and kernel (c)'s launch shapes on each path,
    from its configuration.

    ``paths`` maps a path's name to (config, selection), or (config,
    selection, scenarios per chunk) for a path that solves scenario chunks
    (a chunk of N scenarios runs one outer loop over its N x num_batch
    candidates), or (config, selection, chunk, elite-carry).  Returns (k1,
    k2, k2t, k3, kc): k1 maps (shape, k, kwargs), k2 and k2t (K2's
    lane-major entry) (number of systems, n), k3 (C, S, M+1, k), kc (C, S,
    M, k, maxiter, kernel kind, selection, elite-carry) to {path: launches
    per solve (per chunk)}.  Every (selection, elite-carry) pair runs as
    kernel (c)'s form of it, one launch an outer iteration
    (``inner_launches``), and launches none of K1, K2, K2t and K3: those
    tables name, with 0 launches, the shapes at which the pair's chain (its
    plain version) launches them, which phase 3 checks and times: with
    elite-carry the top-k of the shared iteration-0 batch (1, S, M+1) ("g":
    of the broadcast (C, S, M+1) batch) and the QP of all C x S rows once
    per outer iteration, then the S - n_el fresh rows of every candidate,
    through K2 (K2's lane-major entry under "xt"); without it every row's
    top-k and QP every iteration; "fused" K3 and K2 on every row; and the
    elite pick of every candidate's S costs with K1.  The "xla" selection
    with elite-carry names no chain shape.
    """
    k1, k2, k2t, k3, kc = {}, {}, {}, {}, {}
    for path, (cfg, selection, *rest) in paths.items():
        chunk = rest[0] if rest else 1
        carry = (rest[1] if len(rest) > 1 else True) and selection != "fused"
        b, C = cfg.beta_cem, cfg.cem.num_batch * chunk
        S, n_el, it, outer = (b.num_samples_cem, b.num_ellite, b.maxiter,
                              cfg.cem.maxiter_cem)
        M, k = cfg.risk.num_mother, cfg.risk.num_reduced
        kc.setdefault((C, S, M, k, it, cfg.risk.kernel, selection, carry), {})[path] = outer
        if (selection, carry) == ("xla", True):
            continue
        sel = (("absolute", True), ("slice_to", M))
        # K2 is keyed by (systems, n): two paths may solve as many systems
        # of another size
        t1, t3 = {((C, S), n_el, ())}, set()
        if selection == "fused":
            t3, t2 = {(C, S, M + 1, k)}, {(C * S, k)}
        elif carry:
            t1 |= {((C, S - n_el, M + 1), k, sel), ((C if selection == "g" else 1, S, M + 1),
                                                   k, sel)}
            t2 = {(C * (S - n_el), k), (C * S, k)}
        else:
            t1.add(((C, S, M + 1), k, sel))
            t2 = {(C * S, k)}
        for table, keys in ((k1, t1), (k2t if selection == "xt" else k2, t2), (k3, t3)):
            for key in keys:
                table.setdefault(key, {})[path] = 0
    return k1, k2, k2t, k3, kc


def inner_launches(cfg, selection, carry=True, n=1):
    """The inner CEM's launches in ``n`` solves (or chunks) of ``cfg`` under
    the (selection, elite-carry) pair: kernel (c) once an outer iteration,
    and its form's own count (``ops.inner_cem_fused``, ``_xt``, ``_g``)."""
    from mpc_mmd_tpu_torch.ops.inner_cem import FORMS
    outer = n * cfg.cem.maxiter_cem
    return {"inner_cem": outer,
            **({FORMS[selection].__name__: outer} if selection in FORMS else {})}


def kernels_of(ops, want):
    """The wrappers named in ``want`` with a count above 0."""
    return tuple(fn for fn in ops.KERNELS if want.get(fn.__name__))


def check_launch_shapes(tables, per_solve):
    """The launches per solve of every path that a kernel's shapes name,
    summed over those shapes, must be those its run counted.  ``tables``
    maps a kernel's name to {shape: {path: launches per solve}}."""
    for name, table in tables.items():
        for path in {p for at in table.values() for p in at}:
            want = sum(at.get(path, 0) for at in table.values())
            if per_solve[path].get(name, 0) != want:
                fail(f"{name} on {path}: {per_solve[path].get(name)} launches per "
                     f"solve, but its shapes add up to {want}")


def loop_launches(cfg, n=1, frenet=False, fresh=False, split=False):
    """The launches in ``n`` solves (or chunks) of ``cfg`` on its default
    noise (``noise.JaxNoise``) that every selection makes: the draw
    kernels, one ``prng_plan`` a solve (kernel (a)'s plan form: every
    iteration's rollout noise, which ``det`` does not draw, and outer CEM
    resample, and a Frenet solve's noisy initial states, in one launch)
    and under Beta noise one ``prng_beta`` an outer iteration; a fresh
    solver's first solve also the solver-fixed draws, by ``prng_draws``:
    the initial batch and, in ``mmd_opt``, the inner CEM's samples0, u and
    z (samples0 and z under "exact").  Then
    the outer iteration's kernels (``SolverSetup._routes``): kernel (d) an
    outer iteration except under "exact" (its obstacle-active form in
    ``det``), kernel (e) an outer iteration in every mode except under
    "exact" and with the candidates ``split`` over several ranks; and the
    rollouts (``SolverSetup._glue_routes``): K4n an outer iteration, kernel (f) in
    ``mmd_opt`` and kernel (g) on the road, except under "exact", with the
    candidates split and in ``det``, where the chain launches K4 (``det``
    rolls nothing out); and on the road (g)'s state form once a solve,
    ``det`` included, except under "exact" and with the candidates
    split."""
    outer, det = cfg.cem.maxiter_cem, cfg.risk.mode == "det"
    draws = 0
    if fresh:
        draws += 1 + ((2 if cfg.solve_strategy == "exact" else 3)
                      if cfg.risk.mode == "mmd_opt" else 0)
    beta = 0 if det or cfg.noise.kind != "beta" else n * outer
    prefactored = cfg.solve_strategy == "prefactored"
    project, tail = prefactored, prefactored and not split
    glue = prefactored and not det and not split
    return {"prng_draws": draws, "prng_plan": n, "prng_beta": beta,
            "outer_project": n * outer if project else 0,
            "outer_tail": n * outer if tail else 0,
            "fused_rollout": n * outer if not det and not glue else 0,
            "noisy_rollout": n * outer if glue else 0,
            "inner_prologue": n * outer if glue and cfg.risk.mode == "mmd_opt" else 0,
            "frenet_points": n * outer if glue and frenet else 0,
            "frenet_states": n if prefactored and not split and frenet else 0}


def draw_shapes(paths):
    """The draw kernels' launch shapes on each path, as ``launch_shapes``
    gives K1's: ``paths`` maps a path's name to (config, Frenet?,
    scenarios per chunk).  Returns (plans, draws, beta): kernel (a)'s plan
    form, one launch a solve, {(chunk, iterations, R or None, T, n_cem,
    n_params, initial states or None): {path: 1}}, the arguments of
    ``JaxNoise.plan``; the per-key form's shapes of those segments, {(keys,
    n): {}} (no solve launches it since the plan form: phase 15 holds it to
    its twin there); and {(keys, candidates, n, P): {path: launches per
    solve}} of the Beta draws, 2 keys a scenario over every candidate's R
    x T an outer iteration."""
    from mpc_mmd_tpu_torch.noise import init_state_count
    pl, dr, be = {}, {}, {}

    def add(table, key, path, count):
        at = table.setdefault(key, {})
        at[path] = at.get(path, 0) + count

    for path, (cfg, frenet, chunk) in paths.items():
        outer, R, T = cfg.cem.maxiter_cem, cfg.risk.num_reduced, cfg.horizon.num_prime
        nb, c = cfg.cem.num_batch, cfg.cem
        n_cem = nb - c.ellite_num
        rolls = cfg.risk.mode != "det"
        n_init = init_state_count(cfg) if frenet else None
        add(pl, (chunk, outer, R if rolls else None, T, n_cem, c.num_params, n_init),
            path, 1)
        if rolls:
            dr.setdefault((3 * chunk, R * T), {})
            if cfg.noise.kind == "beta":
                add(be, (2 * chunk, nb, R * T, T), path, outer)
        dr.setdefault((chunk, n_cem * c.num_params), {})
        if frenet:
            dr.setdefault((1, n_init * 4), {})
    return pl, dr, be


def check_topk(torch, ops, topk_plain, gen, shapes):
    """K1 at every path shape (``launch_shapes``), with the edge rows of
    ``kernel_ab.k1_inputs`` (all NaN, NaN lanes, ties, -0.0 against +0.0,
    +-inf, fewer finite lanes than k): indices equal to the twin's exactly.  Returns the selection shape's
    record, with the other shapes under ``cases``."""
    from mpc_mmd_tpu_torch.utils.kernel_ab import k1_inputs
    cases = []
    for (shape, k, kw), at in shapes.items():
        kw = dict(kw)
        x = k1_inputs(gen, shape, k, bool(kw))   # the elite pick ranks -cost
        got = ops.topk_indices(x, k, **kw)
        ref = topk_plain(x, k, **kw)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"K1 topk_indices disagrees with its plain twin at {shape}, k={k} "
                 f"(rows {(got != ref).any(-1).nonzero()[:4].tolist()})")
        m = kw.get("slice_to", shape[-1])
        rows = x.numel() // shape[-1]
        ranked = x[..., :m].abs() if kw.get("absolute") else x[..., :m]
        ranked = ranked.contiguous()                   # outside the timed window
        cases.append(dict(
            shape=f"{shape}, k={k}" + (f", |x| of the first {m} lanes" if kw else ""),
            call=(lambda x=x, k=k, kw=kw: ops.topk_indices(x, k, **kw)),
            match="topk_rounds_kernel", nbytes=f32_bytes(x) + 4 * rows * k,
            ops=rows * k * m, launches_per_solve=at,
            library=(f"torch.topk on the {'|x| slice' if kw else 'rows'}",
                     lambda r=ranked, k=k: torch.topk(r, k, dim=-1)),
            plain_ms=cuda_ms(torch, lambda: topk_plain(x, k, **kw))))
    main = dict(cases[0], max_abs_err=0, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"])
    return main


def check_eq_qp(torch, ops, qp_plain, dev, gen, systems):
    """K2 at every path's number and size of systems (``launch_shapes``),
    built as the inner CEM builds them (``kernel_ab.k2_inputs``), each
    within rtol 1e-4 + atol 1e-5 of the twin run in float64.  Returns the
    fastrt selection's record, with the others under ``cases``."""
    from mpc_mmd_tpu_torch.utils.kernel_ab import k2_inputs
    cases, err = [], 0.0
    for (count, n), at in systems.items():
        C, r = k2_inputs(gen, count, n)
        b, mu = ops.eq_qp_solve(C, r)
        b64, mu64 = qp_plain(C.double(), r.double())
        torch.cuda.synchronize()
        for name, got, ref in (("b", b, b64), ("mu", mu, mu64)):
            bad = (got.double() - ref).abs() > 1e-4 * ref.abs() + 1e-5
            if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                fail(f"K2 eq_qp_solve {name} outside rtol 1e-4 + atol 1e-5 of the "
                     f"float64 twin at {int(bad.sum())} entries ({count} systems)")
        err = max(err, float((b.double() - b64).abs().max()),
                  float((mu.double() - mu64).abs().max()))
        # the bordered (n+1) x (n+1) KKT system [[C, 1], [1^T, 0]] [b; mu] =
        # [r; 1], built outside the timed window
        n = C.shape[-1]
        kkt = torch.zeros(C.shape[:-2] + (n + 1, n + 1), device=dev)
        kkt[..., :n, :n] = C
        kkt[..., :n, n] = 1.0
        kkt[..., n, :n] = 1.0
        rhs = torch.cat((r, torch.ones_like(r[..., :1])), dim=-1)[..., None]
        cases.append(dict(
            shape=f"{count} systems, n={n}",
            call=(lambda C=C, r=r: ops.eq_qp_solve(C, r)), match="eq_qp_kernel",
            nbytes=f32_bytes(C, r, b, mu), ops=count * (n ** 3 // 3 + 4 * n * n),
            launches_per_solve=at,
            library=("torch.linalg.solve on the bordered (n+1)x(n+1) KKT system",
                     lambda kkt=kkt, rhs=rhs: torch.linalg.solve(kkt, rhs)),
            plain_ms=cuda_ms(torch, lambda: qp_plain(C, r), reps=10)))
    main = dict(cases[0], max_abs_err=err, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"])
    return main


def check_eq_qp_t(torch, ops, dev, gen, systems):
    """K2's lane-major entry at every "xt" path's number and size of systems
    (``launch_shapes``; 3,648, 4,096, 8,900 and 10,000 of n = 10, 8,900
    and 10,000 of n = 4), on K2's inputs laid out (n*n, B) and (n, B):
    within rtol 1e-4 + atol 1e-5 of the twin run in float64, and against
    K2's row-major kernel on the same systems (bit-equal: one body; the
    gap is logged and held to the same tolerance).  Returns the fastrt
    shape's record, with the others under ``cases``."""
    from mpc_mmd_tpu_torch.ops.qp import eq_qp_solve_t_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import k2_inputs
    cases, err, gaps = [], 0.0, {}
    for (count, n), at in systems.items():
        C, r = k2_inputs(gen, count, n)
        C_t, r_t = C.reshape(count, n * n).T.contiguous(), r.T.contiguous()
        b_t, mu = ops.eq_qp_solve_t(C_t, r_t)
        b64, mu64 = eq_qp_solve_t_plain(C_t.double(), r_t.double())
        b_rm, mu_rm = ops.eq_qp_solve(C, r)
        torch.cuda.synchronize()
        for name, got, ref in (("b", b_t, b64), ("mu", mu, mu64),
                               ("b vs row-major K2", b_t, b_rm.T.double()),
                               ("mu vs row-major K2", mu, mu_rm.double())):
            bad = (got.double() - ref).abs() > 1e-4 * ref.abs() + 1e-5
            if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                fail(f"K2 lane-major eq_qp_solve_t {name} outside rtol 1e-4 + atol "
                     f"1e-5 of the reference at {int(bad.sum())} entries ({count} "
                     f"systems, n={n})")
        err = max(err, float((b_t.double() - b64).abs().max()),
                  float((mu.double() - mu64).abs().max()))
        gaps[f"{count}, n={n}"] = max(float((b_t - b_rm.T).abs().max()),
                                      float((mu - mu_rm).abs().max()))
        kkt = torch.zeros((count, n + 1, n + 1), device=dev)
        kkt[:, :n, :n] = C
        kkt[:, :n, n] = 1.0
        kkt[:, n, :n] = 1.0
        rhs = torch.cat((r, torch.ones_like(r[:, :1])), dim=-1)[..., None]
        cases.append(dict(
            shape=f"{count} systems, n={n}, lane-major",
            call=(lambda C_t=C_t, r_t=r_t: ops.eq_qp_solve_t(C_t, r_t)),
            match="eq_qp_t_kernel",
            nbytes=4 * count * (n * (n + 1) // 2) + f32_bytes(r_t, b_t, mu),
            ops=count * (n ** 3 // 3 + 4 * n * n), launches_per_solve=at,
            library=("torch.linalg.solve on the bordered (n+1)x(n+1) KKT system",
                     lambda kkt=kkt, rhs=rhs: torch.linalg.solve(kkt, rhs)),
            plain_ms=cuda_ms(torch, lambda: eq_qp_solve_t_plain(C_t, r_t), reps=10)))
    log(f"K2 lane-major against K2 row-major on the same systems, largest gap "
        f"(0.0: equal bits): {gaps}")
    main = dict(cases[0], max_abs_err=err, cases=cases, row_major_gap=gaps)
    main["ms"] = cuda_ms(torch, main["call"])
    return main


def check_rollout(torch, ops, rollout_plain, dev, gen, lanes=6400,
                  per_lane=False, launches_per_solve=None):
    """K4 on ``lanes`` x 50 steps from one shared initial state (6400 in a
    fastrt outer iteration, 25,600 to 51,200 in one of a scenario chunk,
    256,000 in a chunk of the MC validator) or,
    with ``per_lane``, from a state per lane (1,600 in an on-road
    ``mmd_opt`` outer iteration: 100 candidates x 16 mother rollouts, each
    from its noisy initial state; 400 in the other modes' 100 x 4), within
    atol 1e-4 of the twin."""
    acc = (1.0 + 0.5 * torch.randn(lanes, 50, device=dev, generator=gen)).contiguous()
    steer = (0.1 * torch.randn(lanes, 50, device=dev, generator=gen)).contiguous()
    s0 = torch.tensor([0.0, 1.75, 5.0, 0.0, 0.0], device=dev)
    if per_lane:
        s0 = (s0 + torch.tensor([0.05, 0.1, 0.5, 0.1, 0.02], device=dev)
              * torch.randn(lanes, 5, device=dev, generator=gen)).contiguous()
    args = (acc, steer, s0, 0.15, 2.5)
    x, y = ops.fused_rollout(*args)
    xr, yr = rollout_plain(*args)
    torch.cuda.synchronize()
    err = max(float((x - xr).abs().max()), float((y - yr).abs().max()))
    if not err <= 1e-4:
        fail(f"K4 fused_rollout differs from its plain twin by {err} (> 1e-4) "
             f"at {lanes} lanes{', a state per lane' if per_lane else ''}")
    return dict(max_abs_err=err, ms=cuda_ms(torch, lambda: ops.fused_rollout(*args)),
                plain_ms=cuda_ms(torch, lambda: rollout_plain(*args), reps=10),
                shape=f"{lanes} lanes x 50 steps, "
                      + ("a state per lane" if per_lane else "one shared state"),
                call=lambda: ops.fused_rollout(*args), match="rollout_kernel",
                latency_bound_ms=50 * STEP_CYCLES.get("k4", math.nan) / sm_clock_max_mhz()
                / 1e3,
                # two inputs read, two outputs written; ~16 float32
                # operations a lane-step (tan, cos, sin and sqrt as one each)
                nbytes=f32_bytes(acc, steer, s0, x, y), ops=16 * acc.numel(),
                launches_per_solve=launches_per_solve,
                library=("no single call", None))


def check_fused_selection(torch, ops, plain, dev, gen, k3_at):
    """K3 at the dynamic workload's (100, 100, 101) and the fastrt
    (64, 64, 101) selection shapes, k = 10, at the on-road (100, 100,
    17), k = 4, at Path A's chunk of 4 scenarios (400, 100, 101), and at
    Path F's (100, 100, 26), k = 5, and (100, 100, 226), k = 15 (D read
    from device memory there); D from random features.  ``k3_at``:
    ``launch_shapes``' K3 table (the fused chain's shapes, at which no path
    launches K3: kernel (c)'s fused form runs instead).
    Returns the dynamic shape's record, with the on-road, chunk and Path F
    ones under ``cases``."""
    err = 0.0
    cases = []
    for C, S, M, k in ((100, 100, 100, 10), (64, 64, 100, 10), (100, 100, 16, 4),
                       (400, 100, 100, 10), *((100, 100, N * N, N) for N in RECORD_SIZES)):
        at = None if C == 64 else k3_at.get((C, S, M + 1, k), {})
        samples = torch.randn(C, S, M + 1, device=dev, generator=gen)
        samples[..., M] = samples[..., M].abs() * 3 + 0.01
        samples[0, 1, 7] = float("nan")                      # NaN lane
        samples[0, 2, :M] = torch.round(samples[0, 2, :M])   # tied |beta|
        f = torch.randn(C, M, 22, device=dev, generator=gen)
        D = (f[:, :, None, :] - f[:, None, :, :]).abs().sum(-1).contiguous()
        got = ops.topk_kernel_matrices(samples, D, k)
        ref = plain(samples, D, k)
        torch.cuda.synchronize()
        if not torch.equal(got[2], ref[2]) or not bool((got[2][0, 1] == M).all()):
            fail(f"K3 topk_kernel_matrices indices differ from the twin at "
                 f"{(C, S, M + 1)}, k={k}")
        for name, g, r in (("row_sum", got[0], ref[0]), ("K_red", got[1], ref[1])):
            bad = (g - r).abs() > 1e-5 * r.abs() + 1e-6
            if bool(bad.any()) or not bool(torch.isfinite(g).all()):
                fail(f"K3 {name} outside rtol 1e-5 + atol 1e-6 of the twin at "
                     f"{int(bad.sum())} entries, shape {(C, S, M + 1)}, k={k}")
            err = max(err, float((g - r).abs().max()))
        if at is None:
            continue
        call = (lambda s=samples, d=D, k=k: ops.topk_kernel_matrices(s, d, k))
        cases.append(dict(
            shape=f"({C}, {S}, {M + 1}), k={k}", call=call,
            match="topk_kernel_matrices_kernel", launches_per_solve=at,
            nbytes=f32_bytes(samples, D, *got),
            # a division, an exp and an add per (row, selected row, column)
            ops=3 * C * S * k * M, library=("no single call", None),
            plain_ms=cuda_ms(torch, lambda s=samples, d=D, k=k: plain(s, d, k),
                             reps=10)))
    main = dict(cases[0], max_abs_err=err, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"])
    return main


def check_topk_onehot(torch, ops, plain, dev, gen):
    """K5 at (64, 57, 101), k = 10, ranking |x| over the first 100 lanes."""
    x = torch.randn(64, 57, 101, device=dev, generator=gen)
    x[0, 0] = float("nan")
    x[1] = torch.round(x[1] * 2) / 2
    kw = dict(absolute=True, slice_to=100)
    idx, oh = ops.topk_onehot(x, 10, **kw)
    ridx, roh = plain(x, 10, **kw)
    torch.cuda.synchronize()
    if not torch.equal(idx, ridx) or not torch.equal(oh, roh):
        fail("K5 topk_onehot differs from its plain twin")
    call = lambda: ops.topk_onehot(x, 10, **kw)
    return dict(max_abs_err=0.0, ms=cuda_ms(torch, call),
                plain_ms=cuda_ms(torch, lambda: plain(x, 10, **kw)),
                shape="(64, 57, 101), k=10, |x| of the first 100 lanes",
                call=call, match="topk_rounds_kernel", nbytes=f32_bytes(x, idx, oh),
                ops=idx.numel() * 100, library=("no single call", None))


# Kernel (c)'s forms other than "xla": the record's name (the form's own
# launch count), its source and what it replaces
KC_FORMS = {
    "fused": ("inner_cem_fused", "inner_cem_fused.cu",
              "mpc_mmd_tpu/ops/topk_kernel_pallas.py:87 (K3's pallas_call, the "
              "fused selection mpc_mmd_tpu/reduced_set.py:494-496 inside the inner "
              "beta-CEM's lax.scan :740, compiled by XLA)"),
    "xt": ("inner_cem_xt", "inner_cem.cu",
           "mpc_mmd_tpu/ops/qp_pallas.py:85 (K2's lane-major entry and K1 "
           "topk_pallas.py:116, the xt selection mpc_mmd_tpu/reduced_set.py:511-531 "
           "inside the inner beta-CEM's lax.scan :700, compiled by XLA)"),
    "g": ("inner_cem_g", "inner_cem.cu",
          "mpc_mmd_tpu/ops/topk_pallas.py:116 (K1 and K2 qp_pallas.py:109, the g "
          "selection mpc_mmd_tpu/reduced_set.py:497-510 inside the inner beta-CEM's "
          "lax.scan :700, compiled by XLA)")}


def check_inner_cem(torch, ops, gen, shapes):
    """Kernel (c) against its plain versions on the card at every path
    shape and form (``launch_shapes``' (C, S, M, k, maxiter, kind,
    selection, elite-carry), and the shapes it maps to no launch), from the
    same inputs (``kernel_ab.kc_inputs``: a NaN lane and tied |beta| in the
    first batch, and an infinite lane for "fused"; under "g" the
    coefficients whose L1 distances D are).  The "xla" form with elite-carry
    against ``inner_cem_plain``'s "xla" chain: at one iteration the winners'
    indices equal exactly, their weights and bandwidths and the costs
    within rtol 1e-5 + atol 1e-6; at the path's maxiter each candidate's
    costs within rtol 1e-4 + atol 1e-6 at every iteration, for all but at
    most 2 % of a shape's candidates (two costs within round-off may swap
    elites where the resample's products round apart: each such candidate
    is logged with its first iteration apart).  Every other form against
    its pair's chain (``inner_cem_plain(..., selection, carry)``: K1, K2,
    K2t, K3 and PyTorch's operations) bit for bit in every output of every
    candidate (NaN to NaN), at one iteration and the path's; "fused" at a
    chunk of 4 scenarios also against each scenario's candidates alone.
    How many candidates are bit-equal is logged.  Returns {form: record}
    ("xla", "fused", "xt", "g"): a form's first shape's record, its others
    under ``cases`` (the "xla" form without elite-carry among "xla"'s), each
    timed on inputs without the edge rows (``kc_inputs(edges=False)``)."""
    from mpc_mmd_tpu_torch.ops.inner_cem import inner_cem_plain, last_cluster_size, recomputes
    from mpc_mmd_tpu_torch.utils.kernel_ab import kc_inputs
    cases, err = {}, {}
    names = ("beta_w", "sigma_w", "idx_best", "res")
    for (C, S, M, k, maxiter, kind, selection, carry), at in shapes.items():
        label = (f"C={C}, S={S}, M={M}, k={k}, maxiter={maxiter}, {kind}, "
                 f"{selection!r}, elite-carry {carry}")
        strict = (selection, carry) != ("xla", True)
        for iters in (1, maxiter):
            inp, n_el, rho, reg, _, cx, cy = kc_inputs(
                gen, C, S, k, iters, kind, inf_lane=selection == "fused", full=True)
            form = dict(selection=selection, carry=carry,
                        coeffs=(cx, cy) if selection == "g" else None)
            args = (*inp, k, n_el, rho, reg, kind)
            got = ops.inner_cem(*args, **form)
            cluster = last_cluster_size() if got[0].is_cuda else None
            ref = inner_cem_plain(*args, **form)
            torch.cuda.synchronize()
            each = {name: int(((g == r) | (g.isnan() & r.isnan())).reshape(C, -1)
                              .all(dim=1).sum()) for name, g, r in zip(names, got, ref)}
            if strict:
                if each != {name: C for name in names}:
                    fail(f"kernel (c) inner_cem: the form is not bit-equal to its "
                         f"chain at {label}, {iters} iteration(s): {each} of {C}")
                if selection == "fused" and C % 4 == 0 and C >= 400:
                    # a chunk of 4 scenarios against each scenario alone
                    q = C // 4
                    for lo in range(0, C, q):
                        part = (inp[0][lo:lo + q].contiguous(), None, *inp[2:])
                        alone = ops.inner_cem(*part, k, n_el, rho, reg, kind, **form)
                        if not all(torch.equal(a[lo:lo + q], b)
                                   for a, b in zip(got, alone)):
                            fail(f"kernel (c) inner_cem: the fused form's chunk of 4 "
                                 f"differs from its candidates {lo}-{lo + q - 1} "
                                 f"alone at {label}")
            elif not all(bool(torch.isfinite(g).all()) for g in (got[0], got[1], got[3])):
                fail(f"kernel (c) inner_cem: non-finite output at {label}")
            elif iters == 1:
                for name, g, r in (("beta_w", got[0], ref[0]), ("sigma_w", got[1], ref[1]),
                                   ("res", got[3], ref[3])):
                    bad = (g - r).abs() > 1e-5 * r.abs() + 1e-6
                    if bool(bad.any()):
                        fail(f"kernel (c) inner_cem: {name} outside rtol 1e-5 + atol "
                             f"1e-6 of the plain version at {int(bad.sum())} entries, "
                             f"{label} at one iteration")
                if not torch.equal(got[2], ref[2]):
                    fail(f"kernel (c) inner_cem: idx_best differs from the plain "
                         f"version at one iteration, {label}")
            else:
                res_bad = (got[3] - ref[3]).abs() > 1e-4 * ref[3].abs() + 1e-6
                apart = res_bad.any(dim=1).nonzero()[:, 0].tolist()
                for c in apart:
                    log(f"kernel (c) at {label}: candidate {c} parts from the plain "
                        f"version at iteration {int(res_bad[c].int().argmax())} "
                        f"(res {got[3][c].tolist()[:4]}... against "
                        f"{ref[3][c].tolist()[:4]}...)")
                if len(apart) > 0.02 * C:
                    fail(f"kernel (c) inner_cem: {len(apart)} of {C} candidates' costs "
                         f"outside rtol 1e-4 + atol 1e-6 of the plain version, more "
                         f"than 2 %, at {label}")
            gap = ((got[3] - ref[3]).abs().nan_to_num(0.0)).max()
            key = selection if selection in KC_FORMS else "xla"
            err[key] = max(err.get(key, 0.0), float(gap))
            log(f"kernel (c) at {label}, {iters} iteration(s), clusters of {cluster} "
                f"CTA(s) a candidate: {min(each.values())} of {C} candidates bit-equal "
                f"to the plain version in every output ({each}); max |res gap| "
                f"{float(gap):.3e}")
        if not at:
            continue
        # timed on inputs without the edge rows: under "fused" a NaN lane
        # turns every fresh row into a sentinel row, whose rounds it skips
        inp, n_el, rho, reg, _, cx, cy = kc_inputs(gen, C, S, k, maxiter, kind, full=True,
                                                   edges=False)
        form = dict(form, coeffs=(cx, cy) if selection == "g" else None)
        args = (*inp, k, n_el, rho, reg, kind)
        rows = S + (maxiter - 1) * (S if recomputes(selection, carry, M) else S - n_el)
        cases.setdefault(selection if selection in KC_FORMS else "xla", []).append(dict(
            shape=label, call=(lambda a=args, f=form: ops.inner_cem(*a, **f)),
            match="inner_cem_kernel", launches_per_solve=at,
            nbytes=f32_bytes(*(t for t in inp if t is not None), got[0], got[1], got[3])
            + 8 * got[2].numel(),
            # a division, an exp and an add per (row, selected row, column), as K3
            ops=3 * C * rows * k * M, library=("no single call", None),
            was_device_ms=(KC_WAS_MS.get((C, S, M, k, maxiter, kind))
                           if not strict else None),
            plain_ms=cuda_ms(torch, lambda a=args, f=form: inner_cem_plain(*a, **f),
                             reps=3, warmup=1)))
    out = {}
    for key, recs in cases.items():
        main = dict(recs[0], max_abs_err=err[key], cases=recs)
        main["ms"] = cuda_ms(torch, main["call"], reps=20)
        out[key] = main
    return out


def obstacle_terms(cfg):
    """``cfg`` with the obstacle-active projection (``det``'s)."""
    return cfg.replace(projection=dataclasses.replace(cfg.projection,
                                                      with_obstacle_terms=True))


def outer_shapes(paths):
    """Kernel (d)'s and (e)'s launch shapes on each path: ``paths`` maps a
    path's name to (workload, config, on the road, scenarios a chunk).
    Returns (kd, ke): {(workload, scenarios, obstacle-active form?)} and
    {(workload, scenarios, risk mode)}, each to {path: launches per solve
    (per chunk)}, from ``loop_launches``' routes (``det`` takes (d)'s
    obstacle-active form: ``FrenetSolver`` turns the obstacle terms on)."""
    kd, ke = {}, {}
    for path, (name, cfg, frenet, chunk) in paths.items():
        n = loop_launches(cfg, frenet=frenet)
        mode = cfg.risk.mode
        obs = cfg.projection.with_obstacle_terms or mode == "det"
        for table, kernel, key in ((kd, "outer_project", (name, chunk, obs)),
                                   (ke, "outer_tail", (name, chunk, mode))):
            if n[kernel]:
                table.setdefault(key, {})[path] = n[kernel]
    return kd, ke


def _within(torch, got, ref, rtol=1e-5, atol=1e-6):
    """Entries of got outside rtol + atol of ref (NaN only against NaN),
    and how many are bit-equal (NaN to NaN)."""
    both_nan = got.isnan() & ref.isnan()
    ok = ((got - ref).abs() <= rtol * ref.abs() + atol) | both_nan
    return int((~ok).sum()), int(((got == ref) | both_nan).sum())


def check_outer_project(torch, ops, gen, shapes, workloads):
    """Kernel (d) (``ops.outer_project``, ``csrc/outer_project.cu``)
    against its plain version (``outer_project_plain``: ``qp.compute_guess``,
    ``projection.project``, ``dynamics.controls_from_trajectory`` on the
    card) from the same inputs (``kernel_ab.kd_inputs``: row 1's speeds
    saturate the polar clip; the multipliers and lane slack of an
    iteration before; on the road a curved path; the obstacle-active form
    with obstacles on the candidates' way) at every shape a path launches
    it with: every output bit-equal (NaN to NaN), and within rtol 1e-5 +
    atol 1e-6 at the run-time-shape instantiation's num 60, whose bit-equal
    entries are logged.  At the first shape, at the last one (11a's chunk
    of 32) and at every obstacle-active shape each forced launch choice
    (one or two rows a CTA, the run-time-shape instantiation) is bit-equal
    to the launch the wrapper picks.  ``shapes`` maps (workload, scenarios,
    obstacle-active form?) to {path: launches per solve}; ``workloads`` a
    workload's name to (config, on the road).  Returns the first shape's
    record, the others under ``cases``."""
    import dataclasses
    from mpc_mmd_tpu_torch.ops.outer_project import outer_project_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import kd_inputs
    cases, err = [], 0.0
    first, last = next(iter(shapes)), list(shapes)[-1]
    fastrt60 = workloads["fastrt"][0]
    fastrt60 = fastrt60.replace(horizon=dataclasses.replace(fastrt60.horizon, num=60))
    for (name, N, obs), at in list(shapes.items()) + [(("fastrt60", 1, False), None)]:
        cfg, frenet = workloads[name] if name in workloads else (fastrt60, False)
        if obs:
            cfg = obstacle_terms(cfg)
        args, kw = kd_inputs(gen, cfg, N, frenet)
        got = ops.outer_project(*args, **kw)
        ref = outer_project_plain(*args, **kw)
        torch.cuda.synchronize()
        rows, num, nvar = N * cfg.cem.num_batch, cfg.horizon.num, cfg.horizon.nvar
        label = f"{name} x {N}: {rows} rows, num {num}" + (", obstacle terms" if obs else "")
        equal = {}
        for field, g, r in zip(got._fields, got, ref):
            bad, same = _within(torch, g, r)
            if bad:
                fail(f"kernel (d) outer_project: {field} outside rtol 1e-5 + atol 1e-6 "
                     f"of the plain version at {bad} entries, {label}")
            if at is not None and same != r.numel():
                fail(f"kernel (d) outer_project: {field} not bit-equal to the plain "
                     f"version at {r.numel() - same} entries, {label}")
            equal[field] = f"{same}/{r.numel()}"
            err = max(err, float((g - r).abs().nan_to_num(0.0).max()))
        log(f"kernel (d) at {label}: bit-equal entries {equal}")
        if (name, N, obs) in (first, last) or obs:
            for forced in ({"rows_per_cta": 1}, {"rows_per_cta": 2}, {"runtime_shape": True},
                           {"rows_per_cta": 2, "runtime_shape": True}):
                other = ops.outer_project(*args, **kw, **forced)
                torch.cuda.synchronize()
                for field, g, r in zip(got._fields, other, got):
                    if not bool(((g == r) | (g.isnan() & r.isnan())).all()):
                        fail(f"kernel (d) outer_project: {field} at {forced} not bit-equal "
                             f"to the picked launch, {label}")
            log(f"kernel (d) at {label}: one and two rows a CTA, compile-time and run-time "
                "shape bit-equal")
        if at is None:
            continue
        nl, it = 2 * (num - 1), cfg.projection.maxiter
        nx, ny = nvar + 3, nvar + 4
        mats = (2 * cfg.guess.num_segments * nvar + 2 * (nx * nx + ny * ny)
                + 3 * num * nvar + nl * nvar)
        # a product's multiply-add counts two operations; about 60 elementwise
        # operations a step and round (each trigonometric call as one)
        ops_row = (2 * nvar * (8 * num + it * (14 * num + 3 * nl))
                   + 2 * (nx * nx + ny * ny) * (it + 1) + 60 * num * (it + 1))
        obs_floats = 0
        if obs:     # the obstacles once; a round's polar steps and 4 chains of P
            nblk = cfg.obstacles.num_obs * cfg.obstacles.num_circles
            obs_floats = 2 * kw["x_obs"].numel()
            ops_row += (it + 1) * (40 * nblk * num + 8 * nvar * num)
        cases.append(dict(
            shape=label, call=(lambda a=args, k=kw: ops.outer_project(*a, **k)),
            match="outer_project_kernel", launches_per_solve=at,
            nbytes=4 * (rows * (8 + 7 + 2 * nvar + nl) + mats
                        + sum(kw[k].numel() for k in ("arc_vec", "kappa") if k in kw)
                        + rows * (4 * nvar + 10 * num + 1 + nl) + obs_floats),
            ops=rows * ops_row, library=("no single call", None), cold=True,
            plain_ms=cuda_ms(torch, lambda a=args, k=kw: outer_project_plain(*a, **k),
                             reps=3, warmup=1)))
    main = dict(cases[0], max_abs_err=err, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"], reps=20)
    return main


def check_outer_tail(torch, ops, gen, shapes, workloads):
    """Kernel (e) (``ops.outer_tail``, ``csrc/outer_tail.cu``) against its
    plain version (``outer_tail_plain``: the mode's risk and
    ``sampling.cem_tail`` on the card) from the same inputs
    (``kernel_ab.ke_inputs``: the best elite copied to the last candidate,
    a tie in risk and in cost; a rollout with a NaN and a candidate whose
    rollouts violate nothing) at every shape and risk form a path launches
    it with, and at the first shape once more with a covariance that is not
    positive definite: the kept candidates, the elites and the pick equal exactly,
    or each difference a near-tie (the plain version's risks or costs
    within 1e-6 relative), and the moments, parameters, risks and res
    within rtol 1e-5 + atol 1e-6 (NaN only against NaN); how many entries
    are bit-equal is logged; at the path shapes every output is bit-equal
    (NaN to NaN), res_2 too.  At the first shape of each risk form, each
    cluster size (1, 2, 4, 8 CTAs a scenario) is bit-equal to the picked
    one, and every CTA of a cluster keeps the same candidates.  ``shapes``
    maps (workload, scenarios, risk mode) to {path: launches per solve};
    ``workloads`` as :func:`check_outer_project`'s."""
    from mpc_mmd_tpu_torch.ops.outer_tail import last_cluster_size, outer_tail_plain
    from mpc_mmd_tpu_torch.risk import obstacle_risk
    from mpc_mmd_tpu_torch.utils.kernel_ab import ke_inputs
    cases, err, forms = [], 0.0, set()
    first = next(iter(shapes))
    for (name, N, mode), at, nonpd in [(k, v, False) for k, v in shapes.items()] + [
            (first, {}, True)]:
        cfg, frenet = workloads[name]
        cfg = cfg.with_risk_mode(mode)
        args = ke_inputs(gen, cfg, N, frenet, nonpd)
        res_k, res_p = args[15].clone(), args[15].clone()
        res2_k, res2_p = args[16].clone(), args[16].clone()
        got = ops.outer_tail(*args[:15], res_k, res2_k, args[17])
        cluster = last_cluster_size() if got.mean.is_cuda else None
        ref = outer_tail_plain(*args[:15], res_p, res2_p, args[17])
        torch.cuda.synchronize()
        if mode not in forms and not nonpd:
            forms.add(mode)
            n_cost = got.kept.shape[1]
            for cs in (1, 2, 4, 8):
                per_cta = torch.full((N * cs, n_cost), -1, dtype=torch.int64,
                                     device=got.kept.device)
                r1, r2 = args[15].clone(), args[16].clone()
                other = ops.outer_tail(*args[:15], r1, r2, args[17], cluster=cs,
                                       kept_cta=per_cta)
                torch.cuda.synchronize()
                for g, r in zip(tuple(other) + (r1, r2), tuple(got) + (res_k, res2_k)):
                    if not bool(((g == r) | (g.isnan() & r.isnan())).all()):
                        fail(f"kernel (e) outer_tail: a cluster of {cs} not bit-equal to "
                             f"the picked one at {name} x {N} {mode}")
                if got.mean.is_cuda and not torch.equal(
                        per_cta.reshape(N, cs, n_cost), other.kept[:, None].expand(
                            N, cs, n_cost)):
                    fail(f"kernel (e) outer_tail: the CTAs of a cluster of {cs} keep other "
                         f"candidates at {name} x {N} {mode}")
            log(f"kernel (e) at {name} x {N} {mode}: clusters of 1, 2, 4, 8 bit-equal, "
                "every CTA keeps the same candidates")
        nb, c = cfg.cem.num_batch, cfg.cem
        label = (f"{name} x {N} {mode}: {N * nb} candidates, R {cfg.risk.num_reduced}"
                 + (", a covariance not positive definite" if nonpd else ""))
        for field in ("kept", "elites", "best"):
            g, r = getattr(got, field), getattr(ref, field)
            if torch.equal(g, r):
                continue
            if args[7] is None:
                fail(f"kernel (e) outer_tail: {field} differ from the plain version at "
                     f"{label}: {g.tolist()} against {r.tolist()}")
            # near-ties: the plain version's risks (kept) of the two picks
            rk = obstacle_risk(cfg, *args[5:11])
            n_ix = torch.arange(N, device=rk.device)[:, None]
            a_v = rk[n_ix, got.kept if field != "best" else got.best[:, None]]
            b_v = rk[n_ix, ref.kept if field != "best" else ref.best[:, None]]
            if field == "elites" or not bool(
                    ((a_v - b_v).abs() <= 1e-6 * b_v.abs()).all()):
                fail(f"kernel (e) outer_tail: {field} differ from the plain version at "
                     f"{label}: {g.tolist()} against {r.tolist()}")
            log(f"kernel (e) at {label}: {field} differ only at near-ties of risk")
        equal = {}
        for field, g, r in (("mean", got.mean, ref.mean), ("cov", got.cov, ref.cov),
                            ("params", got.params, ref.params),
                            ("risk_obs", got.risk_obs, ref.risk_obs),
                            ("risk_lane", got.risk_lane, ref.risk_lane),
                            ("res", res_k, res_p), ("res_2", res2_k, res2_p)):
            bad, same = _within(torch, g, r)
            if bad:
                fail(f"kernel (e) outer_tail: {field} outside rtol 1e-5 + atol 1e-6 of "
                     f"the plain version at {bad} entries, {label}")
            if same != r.numel():
                fail(f"kernel (e) outer_tail: {field} not bit-equal to the plain version "
                     f"at {r.numel() - same} entries, {label}")
            equal[field] = f"{same}/{r.numel()}"
            err = max(err, float((g - r).abs().nan_to_num(0.0).max()))
        if nonpd and not bool(got.params[0, c.ellite_num:].isnan().all()):
            fail(f"kernel (e) outer_tail: the resample of a covariance that is not "
                 f"positive definite is not NaN, {label}")
        log(f"kernel (e) at {label}, clusters of {cluster} CTA(s) a scenario: kept, "
            f"elites and pick equal; bit-equal entries {equal}")
        if nonpd:
            continue
        R, T, num = cfg.risk.num_reduced, cfg.horizon.num_prime, cfg.horizon.num
        n_cost = min(c.ellite_num_cost, nb)
        nobs = args[9].shape[1]
        # what the form reads: the rollouts and obstacles (all but det), the
        # weights and bandwidths (the MMD forms); the lane risks it scores
        rolls = mode != "det"
        mmd = mode in ("mmd_opt", "mmd_random")
        lanes = rolls and (frenet or mode != "mmd_random")
        # per candidate's reduction of R samples: an MMD's R^2 kernel values
        # (8 operations each), CVaR's R^2 comparisons of its sort (3 each),
        # SAA's R comparisons
        red = 8 * R * R if mmd else 3 * R * R if mode == "cvar" else R if rolls else 0
        cases.append(dict(
            shape=label, call=(lambda a=args: ops.outer_tail(*a)),
            match="outer_tail_kernel", launches_per_solve=at,
            # the rollouts, weights and bandwidths, the kept rows (7 of num),
            # the parameters, normals, moments and obstacles once; the outputs
            nbytes=4 * N * (rolls * 2 * nb * R * T + mmd * (nb * R + nb) + n_cost * 7 * num
                            + 2 * nb * 8 + 8 + 64 + rolls * 2 * nobs * T + 2 * nb + 2)
            + 4 * N * (8 + 64 + nb * 8 + 5),
            # 8 operations a violation, the reductions, 6 a lane violation,
            # 30 a step of a kept candidate's cost, and the update's products
            ops=N * (rolls * 8 * nb * R * nobs * T + red * (nb + lanes * 2 * n_cost)
                     + lanes * 6 * n_cost * R * T + 30 * n_cost * num
                     + 2 * (nb - c.ellite_num) * 64 + 4 * c.ellite_num * 64),
            library=("no single call", None), cold=True,
            plain_ms=cuda_ms(torch, lambda a=args: outer_tail_plain(*a), reps=3,
                             warmup=1)))
    main = dict(cases[0], max_abs_err=err, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"], reps=20)
    return main


def glue_shapes(paths):
    """K4n's, kernel (f)'s and kernel (g)'s launch shapes on each path, as
    ``outer_shapes`` gives kernel (d)'s: ``paths`` maps a path's name to
    (workload, config, on the road, scenarios a chunk).  Returns (k4n, kf,
    kg, ks): {(workload, scenarios, mother rollouts?)}, {(workload,
    scenarios, MMD kernel)}, {(workload, scenarios)} and (g)'s state form's
    {(workload, initial states)}, each to {path: launches per solve (per
    chunk)}, from ``loop_launches``' routes."""
    from mpc_mmd_tpu_torch.noise import init_state_count
    k4n, kf, kg, ks = {}, {}, {}, {}
    for path, (name, cfg, frenet, chunk) in paths.items():
        n = loop_launches(cfg, frenet=frenet)
        for table, kernel, key in (
                (k4n, "noisy_rollout", (name, chunk, cfg.risk.mode == "mmd_opt")),
                (kf, "inner_prologue", (name, chunk, cfg.risk.kernel)),
                (kg, "frenet_points", (name, chunk)),
                (ks, "frenet_states", (name, init_state_count(cfg)))):
            if n[kernel]:
                table.setdefault(key, {})[path] = n[kernel]
    return k4n, kf, kg, ks


def _bits_apart(got, ref):
    """Entries of got that are not ref's bits (NaN to NaN)."""
    return int((~((got == ref) | (got.isnan() & ref.isnan()))).sum())


def glue_clock_builds():
    """``utils/kernel_ab.py``'s clock variants of K4n and kernels (f) and (h)
    from this checkout's sources (``k4n_clock``, ``kf_clock``, ``kh_clock``:
    thread 0 of each block stamps the cycles of each phase) and its step
    microbenchmark (``step_now``), built beside the package."""
    from mpc_mmd_tpu_torch.ops import _build
    from mpc_mmd_tpu_torch.utils import kernel_ab
    srcs = {f"{kind}_clock": (kind, kernel_ab.glue_clock_variant(
        kind, (_build.CSRC / src).read_text(), f"{kind}_clock"))
        for kind, src in (("k4n", "rollout.cu"), ("kf", "inner_prologue.cu"),
                          ("kh", "local_frame.cu"))}
    srcs["step_now"] = ("step", kernel_ab.STEP_MICRO)
    return kernel_ab.build_all(srcs, lambda msg: log(f"  {msg}"))


def phase_cycles(wrapper, args, clocks, name, per=None):
    """The mean cycles thread 0 of a block spends in each phase of the
    clock build ``name`` of ``clocks`` (``glue_clock_builds``) at these
    arguments, and with ``per`` the steps' cycles a step; {} without it."""
    from mpc_mmd_tpu_torch.utils import kernel_ab
    if name not in clocks:
        return {}
    got = kernel_ab._clock_regions(clocks[name], name,
                                   lambda: wrapper(*args, lib=clocks[name]),
                                   entry=kernel_ab.GLUE_CLOCK_ENTRY)
    out = {r: round(v["mean"]) for r, v in got["cycles"].items()}
    if per and "steps" in out:
        out["steps_per_step"] = round(out["steps"] / per, 1)
    return out


def check_noisy_rollout(torch, ops, gen, shapes, workloads, clocks=None):
    """K4n (``ops.noisy_rollout``, ``csrc/rollout.cu``'s noisy-controls
    entry) against its plain version (``noisy_rollout_plain``:
    ``perturb_controls``, the mother pairing and K4 on the card) from the
    same inputs (``kernel_ab.k4n_inputs``: exact zeros in the controls as
    every solve has) at every shape a path launches it with (fastrt x 1, 4,
    8, Path A's mother rollouts and Path B's R under Beta noise, Path D's
    from a state per lane, F5, F15) and once with const noise: x and y
    bit-equal.  ``shapes`` maps (workload, scenarios, mother?) to {path:
    launches per solve}.  Returns the first shape's record, the others
    under ``cases``."""
    from mpc_mmd_tpu_torch.ops.rollout import noisy_rollout_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import k4n_inputs
    cases = []
    for (name, N, mother), at, const in ([(key, at, 0.0) for key, at in shapes.items()]
                                         + [(next(iter(shapes)), None, 0.02)]):
        cfg, frenet = workloads[name]
        cfg = cfg if mother else cfg.with_risk_mode("cvar")
        args = k4n_inputs(gen, cfg, N, frenet, const)
        got = ops.noisy_rollout(*args)
        ref = noisy_rollout_plain(*args)
        torch.cuda.synchronize()
        lanes, T = got[0].numel() // got[0].shape[-1], got[0].shape[-1]
        label = (f"{name} x {N}: {lanes:,} lanes x {T}, {cfg.noise.kind} noise"
                 + (", a state per lane" if frenet else "")
                 + (f", const noise {const}" if const else ""))
        for field, g, r in zip("xy", got, ref):
            bad = _bits_apart(g, r)
            if bad:
                fail(f"K4n noisy_rollout: {field} not bit-equal to the plain version at "
                     f"{bad} entries, {label}")
        log(f"K4n at {label}: x and y bit-equal to the plain version")
        if at is None:
            continue
        cases.append(dict(
            shape=label, call=(lambda a=args: ops.noisy_rollout(*a)),
            match="noisy_rollout_kernel", launches_per_solve=at, cold=True,
            phases=phase_cycles(ops.noisy_rollout, args, clocks or {}, "k4n_clock", per=T),
            # the latency bound: T steps of one lane's chain at the card's
            # highest SM clock
            latency_bound_ms=T * STEP_CYCLES.get("k4n", math.nan) / sm_clock_max_mhz() / 1e3,
            # the controls and the draws read once, the positions written;
            # K4's 16 operations a lane-step and 5 of the noise
            nbytes=f32_bytes(*args[:6], *got), ops=21 * lanes * T,
            library=("no single call", None),
            plain_ms=cuda_ms(torch, lambda a=args: noisy_rollout_plain(*a), reps=5,
                             warmup=1)))
    main = dict(cases[0], max_abs_err=0.0, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"], reps=20)
    return main


def check_inner_prologue(torch, ops, gen, shapes, workloads, clocks=None):
    """Kernel (f) (``ops.inner_prologue``, ``csrc/inner_prologue.cu``)
    against its plain version (``inner_prologue_plain``:
    ``qp.refit_coefficients``' cuBLAS products and
    ``kernels.distance_matrices`` on the card) from the same rollouts
    (``kernel_ab.kf_inputs``) at every shape a path launches it with
    (fastrt x 1, 4, 8, Path A, Path D's M = 16, F5's M = 25, F15's M = 225),
    at fastrt with the gaussian and matern52 kernels (D2), and at fastrt
    with Bernstein order 7 (nvar 8: the run-time feature count, every path
    taking the compile-time one) under matern52: cx, cy, D and D2
    bit-equal.  ``shapes`` maps (workload, scenarios, MMD kernel) to
    {path: launches per solve}.  Returns the first shape's record, the
    others under ``cases``."""
    import dataclasses
    from mpc_mmd_tpu_torch.ops.inner_prologue import inner_prologue_plain
    from mpc_mmd_tpu_torch.utils.kernel_ab import kf_inputs
    fastrt = workloads["fastrt"][0]
    workloads = dict(workloads, fastrt_order7=(fastrt.replace(
        horizon=dataclasses.replace(fastrt.horizon, order=7)), False))
    cases = []
    for (name, N, kind), at in list(shapes.items()) + [(("fastrt_order7", 1, "matern52"),
                                                        {})]:
        cfg = workloads[name][0]
        args = kf_inputs(gen, cfg, N, kind)
        got = ops.inner_prologue(*args)
        ref = inner_prologue_plain(*args)
        torch.cuda.synchronize()
        B, M, nvar = got.cx.shape
        T = args[1].shape[-1]
        label = f"{name} x {N}: {B} candidates x {M} rollouts x {T}, nvar {nvar}, {kind}"
        for field, g, r in zip(got._fields, got, ref):
            if (g is None) != (r is None):
                fail(f"kernel (f) inner_prologue: {field} given by one version only, {label}")
            bad = 0 if g is None else _bits_apart(g, r)
            if bad:
                fail(f"kernel (f) inner_prologue: {field} not bit-equal to the plain "
                     f"version at {bad} of {r.numel()} entries, {label}")
        log(f"kernel (f) at {label}: cx, cy, D" + (", D2" if got.D2 is not None else "")
            + " bit-equal to the plain version")
        if not at:
            continue
        F = 2 * nvar
        feats = torch.cat((got.cx, got.cy), dim=-1)
        cases.append(dict(
            shape=label, call=(lambda a=args: ops.inner_prologue(*a)),
            match="inner_prologue_kernel", launches_per_solve=at, cold=True,
            phases=phase_cycles(ops.inner_prologue, args, clocks or {}, "kf_clock"),
            nbytes=f32_bytes(args[1], args[2], args[0].P_prime, args[0].refit_inv,
                             *(t for t in got if t is not None)),
            # the two products' multiply-adds count two; a difference, an
            # absolute value and an add a feature of every entry of D
            ops=2 * 2 * B * M * (T * nvar + nvar * nvar) + 3 * F * B * M * M
            + (5 * F * B * M * M if got.D2 is not None else 0),
            library=("torch.cdist(f, f, p=1) of the features, D alone",
                     lambda f=feats: torch.cdist(f, f, p=1)),
            plain_ms=cuda_ms(torch, lambda a=args: inner_prologue_plain(*a), reps=5,
                             warmup=1)))
    main = dict(cases[0], max_abs_err=0.0, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"], reps=20)
    return main


# Work of kernel (g)'s search, for its bound: about 5 float operations a
# (point, path point) pair of a tile its warp visits (two differences, two
# squares, an add; the compare and the select ride on them) and 7 a (point,
# tile) bound (two compares and differences, two squares, an add); a
# full scan does the 5 for every pair
KG_PAIR_OPS, KG_BOUND_OPS = 5, 7


def search_work(torch, frame, x, visits):
    """(operations of the search these points needed, the full scan's, the
    tiles visited a point (mean, max)) from the probe's visits."""
    from mpc_mmd_tpu_torch.ops.frenet_points import TILE
    n = frame.x_path.shape[0]
    tiles = -(-n // TILE)
    v = visits.double()
    pairs = float(torch.clamp(v * TILE, max=n).sum())
    ops_ = KG_PAIR_OPS * pairs + KG_BOUND_OPS * x.numel() * tiles
    return ops_, KG_PAIR_OPS * x.numel() * n, (float(v.mean()), int(visits.max()))


def probe_against_twin(torch, form, idx, visits, tx, ty, frame, label):
    """A probe launch's nearest indices and visited tiles (kernel (g)'s
    ``form``) against the twin's (``nearest_pruned``) at the points tx, ty;
    returns the visits."""
    from mpc_mmd_tpu_torch.ops.frenet_points import nearest_pruned
    tidx, tvisits = nearest_pruned(frame, tx, ty)
    torch.cuda.synchronize()
    if not (torch.equal(idx.long(), tidx) and torch.equal(visits.long(), tvisits)):
        fail(f"kernel (g) {form} at {label}: indices or visited tiles not the twin's "
             f"({int((idx.long() != tidx).sum())} indices, "
             f"{int((visits.long() != tvisits).sum())} visits apart)")
    return visits


def points_against_plain(torch, ops, frame, x, y, label):
    """Kernel (g)'s rollout form (``ops.frenet_points``, the launch the
    path makes) against global_to_frenet_points, s and l bit for bit; its
    probe launch the same, with its indices and visited tiles against the
    twin's.  Returns (s, l, visits)."""
    from mpc_mmd_tpu_torch.frenet import global_to_frenet_points
    got = ops.frenet_points(frame, x, y)
    *probed, idx, visits = ops.frenet_points(frame, x, y, probe=True)
    ref = global_to_frenet_points(frame, x, y)
    torch.cuda.synchronize()
    for launch, out in (("", got), (" (its probe)", probed)):
        for field, g, r in zip(("s", "l"), out, ref):
            bad = _bits_apart(g, r)
            if bad:
                fail(f"kernel (g) frenet_points{launch}: {field} not bit-equal to the plain "
                     f"version at {bad} entries, {label}")
    probe_against_twin(torch, "frenet_points", idx, visits, x, y, frame, label)
    return (*got, visits)


def check_frenet_points(torch, ops, gen, shapes, workloads):
    """Kernel (g) (``ops.frenet_points``, ``csrc/frenet_points.cu``)
    against its plain version (``frenet.global_to_frenet_points`` on the
    card) from the same points, s and l bit-equal, and its nearest indices
    and visited tiles against the twin's (``nearest_pruned``): at every
    shape a path launches it with (``kernel_ab.kg_inputs``: Path D's 100
    candidates x 4 rollouts x 50 around a curved path of 600 points, with a
    point equidistant from two path points, points before the path's start
    and past its end, one on the last path point and a NaN), at a chunk of
    4 of them, on a closed-loop frame (``kernel_ab.kg_closedloop``) and on
    ``kernel_ab.kg_case``'s adversarial inputs; the tiles visited a point
    logged.  ``shapes`` maps (workload, scenarios) to {path: launches per
    solve}.  Returns the first shape's record, the others (the chunk of 4,
    the closed-loop frame and the two inputs on which every warp visits
    every tile) under ``cases``."""
    from mpc_mmd_tpu_torch.frenet import global_to_frenet_points
    from mpc_mmd_tpu_torch.ops.frenet_points import TILE
    from mpc_mmd_tpu_torch.utils.kernel_ab import (KG_CASES, KG_FULL, kg_case,
                                                   kg_closedloop, kg_inputs)
    name0 = next(iter(shapes))[0]
    inputs = [(f"{name} x {N}", kg_inputs(gen, workloads[name][0], N), at)
              for (name, N), at in shapes.items()]
    inputs.append((f"{name0} x 4", kg_inputs(gen, workloads[name0][0], 4), None))
    inputs.append((f"{name0} x 1 on a closed-loop frame",
                   kg_closedloop(gen, workloads[name0][0])[0], None))
    inputs += [(case, kg_case(case, gen.device), None) for case in KG_CASES]
    cases = []
    for label, (frame, x, y), at in inputs:
        n = frame.x_path.shape[0]
        label = f"{label}: {x.numel():,} points, a path of {n}"
        *got, visits = points_against_plain(torch, ops, frame, x, y, label)
        work, full, (mean, most) = search_work(torch, frame, x, visits)
        log(f"kernel (g) at {label}: s and l bit-equal to the plain version (the launch "
            f"and its probe), the probe's indices and visited tiles the twin's; tiles "
            f"visited a point: mean {mean:.2f}, max {most} of {-(-n // TILE)}; search "
            f"{work:.3g} operations (the full scan {full:.3g})")
        if not (at is not None or label.startswith(f"{name0} x 4")
                or "closed-loop" in label or label.split(":")[0] in KG_FULL):
            continue
        cases.append(dict(
            shape=label, call=(lambda a=(frame, x, y): ops.frenet_points(*a)),
            match="frenet_points_kernel", launches_per_solve=at, cold=True,
            nbytes=f32_bytes(x, y, *got, *frame[:5]), ops=work, full_scan_ops=full,
            tiles_visited={"mean": mean, "max": most},
            library=("no single call", None),
            plain_ms=cuda_ms(torch, lambda a=(frame, x, y): global_to_frenet_points(*a),
                             reps=5, warmup=1)))
    main = dict(cases[0], max_abs_err=0.0, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"], reps=20)
    return main


def check_frenet_states(torch, ops, gen, shapes, workloads):
    """Kernel (g)'s state form (``ops.frenet_states``) against its plain
    version (``frenet.initial_states`` on the card) from the same draws
    (``kernel_ab.kg_state_inputs``) at every on-road mode's number of
    states (``shapes``: {(workload, states): {path: launches per solve}}:
    Path D's 16 in ``mmd_opt``, 4 in ``cvar`` / ``saa`` / ``mmd_random``,
    1 in ``det``) on the closed-loop frame, at 100 and 256 states (ATen's
    one-output sums past a warp and vectorised) and at 16 on adversarial
    frames: the states and boundary rows bit-equal, and the nearest
    indices and visited tiles (its probe) the twin's.  Returns the first
    shape's record, the other timed shapes under ``cases``."""
    from mpc_mmd_tpu_torch.frenet import initial_states
    from mpc_mmd_tpu_torch.utils.kernel_ab import kg_case, kg_closedloop, kg_state_inputs
    name0 = next(iter(shapes))[0]
    cfg = workloads[name0][0]
    frame = kg_closedloop(gen, cfg)[0][0]
    runs = [(f"{name} x {n} states on a closed-loop frame", frame, n, (0.0, 0.0), at)
            for (name, n), at in shapes.items()]
    runs += [(f"{n} states on a closed-loop frame", frame, n, (0.0, 0.0), None)
             for n in (100, 256)]
    for case in ("tie_between_non_adjacent_tiles", "duplicate_path_points",
                 "nan_path_point", "squares_overflow"):
        f, x, y = kg_case(case, gen.device)
        runs.append((f"16 states on {case}", f, 16, (float(x[0]), float(y[0])), None))
    cases = []
    for label, fr, n, where, at in runs:
        args = kg_state_inputs(gen, cfg, fr, n, where)
        got = ops.frenet_states(*args)
        ref = initial_states(*args)
        *_, idx, visits = ops.frenet_states(*args, probe=True)
        torch.cuda.synchronize()
        for field, g, r in zip(("states", "b_eq_x", "b_eq_y"), got, ref):
            bad = _bits_apart(g, r)
            if bad:
                fail(f"kernel (g) frenet_states: {field} not bit-equal to the plain "
                     f"version at {bad} entries, {label}")
        xs = got[0][:, 0]
        probe_against_twin(torch, "frenet_states", idx, visits, xs, got[0][:, 1], fr, label)
        work, _, (mean, most) = search_work(torch, fr, xs, visits)
        log(f"kernel (g) frenet_states at {label}: states, b_eq_x, b_eq_y bit-equal to "
            f"frenet.initial_states; tiles visited a state: mean {mean:.2f}, max {most}")
        if at is None and n != 256:
            continue
        cases.append(dict(
            shape=label, call=(lambda a=args: ops.frenet_states(*a)),
            match="frenet_states_kernel", launches_per_solve=at, cold=True,
            nbytes=f32_bytes(args[1], args[2], *got, *fr[:6]),
            # the search, and about 150 operations a state: three insertion
            # points, four interpolations, atan2 three times, sin and cos
            # twice, the chain rule; the sums
            ops=work + 150 * n, tiles_visited={"mean": mean, "max": most},
            library=("no single call", None),
            plain_ms=cuda_ms(torch, lambda a=args: initial_states(*a), reps=5, warmup=1)))
    main = dict(cases[0], max_abs_err=0.0, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"], reps=20)
    return main


def check_frenet_obstacles(torch, ops, gen, workloads, per_step):
    """Kernel (g)'s obstacle form (``ops.frenet_obstacles``) against its
    plain version (``frenet.global_to_frenet_obstacle`` on the card) at
    the closed loop's obstacles on a closed-loop frame
    (``kernel_ab.kg_closedloop``) and at adversarial positions
    (``kernel_ab.kg_case``'s points, random velocities and headings): every
    output bit-equal, and the nearest indices and visited tiles (its probe)
    the twin's; with the horizon's times (as local_problem launches it) also
    the constant-velocity trajectories x_obs, y_obs bit-equal to
    ``dynamics.constant_velocity_obstacles``.  ``per_step``: {path:
    launches a step}.  Returns the closed-loop shape's record (with the
    trajectories)."""
    from mpc_mmd_tpu_torch.dynamics import constant_velocity_obstacles
    from mpc_mmd_tpu_torch.frenet import global_to_frenet_obstacle
    from mpc_mmd_tpu_torch.utils.kernel_ab import kg_case, kg_closedloop
    cfg = workloads["path_d"][0]
    (frame, _, _), obs = kg_closedloop(gen, cfg)
    tot = torch.linspace(0.0, cfg.horizon.t_fin, cfg.horizon.num, device=gen.device)
    runs = [(f"path_d's {obs.shape[0]} obstacles on a closed-loop frame", frame, obs)]
    for case in ("far_off_the_path", "non_finite_query", "inf_path_point",
                 "duplicate_path_points", "ragged_sizes"):
        f, x, y = kg_case(case, gen.device)
        m = x.shape[0]
        o = torch.stack((x, y, 3.0 * torch.randn(m, device=gen.device, generator=gen),
                         torch.randn(m, device=gen.device, generator=gen),
                         3.0 * torch.rand(m, device=gen.device, generator=gen)), dim=1)
        runs.append((f"{m} obstacles on {case}", f, o))
    outs = []
    for label, fr, o in runs:
        got = ops.frenet_obstacles(fr, o)
        *probed, idx, visits = ops.frenet_obstacles(fr, o, probe=True)
        ref = global_to_frenet_obstacle(fr, *o.unbind(1))
        torch.cuda.synchronize()
        for launch, out in (("", got), (" (its probe)", probed)):
            for field, g, r in zip(("s", "l", "vs", "vl", "psi_rel"), out, ref):
                bad = _bits_apart(g, r)
                if bad:
                    fail(f"kernel (g) frenet_obstacles{launch}: {field} not bit-equal to "
                         f"the plain version at {bad} entries, {label}")
        probe_against_twin(torch, "frenet_obstacles", idx, visits, o[:, 0], o[:, 1], fr,
                           label)
        traj = ops.frenet_obstacles(fr, o, tot_time=tot)
        ref_t = tuple(ref) + constant_velocity_obstacles(*ref, tot)[:2]
        torch.cuda.synchronize()
        for field, g, r in zip(("s", "l", "vs", "vl", "psi_rel", "x_obs", "y_obs"), traj,
                               ref_t):
            bad = _bits_apart(g, r)
            if bad:
                fail(f"kernel (g) frenet_obstacles with the horizon's times: {field} not "
                     f"bit-equal to the chain at {bad} entries, {label}")
        log(f"kernel (g) frenet_obstacles at {label}: every output bit-equal to "
            f"global_to_frenet_obstacle (the launch and its probe), the probe's indices "
            f"and visited tiles the twin's; with the horizon's times x_obs and y_obs "
            f"bit-equal to constant_velocity_obstacles")
        outs.append((got, visits))
    got, visits = outs[0]
    work, _, (mean, most) = search_work(torch, frame, obs[:, 0], visits)
    traj = ops.frenet_obstacles(frame, obs, tot_time=tot)

    def plain():
        conv = global_to_frenet_obstacle(frame, *obs.unbind(1))
        return constant_velocity_obstacles(*conv, tot)
    rec = dict(shape=f"{runs[0][0]}, with {tot.shape[0]} times",
               call=(lambda: ops.frenet_obstacles(frame, obs, tot_time=tot)),
               match="frenet_points_kernel", launches_per_solve=per_step, cold=True,
               nbytes=f32_bytes(obs, tot, *traj, *frame[:6]),
               # the search, about 80 operations an obstacle (its frame,
               # kappa, the heading, vs, vl) and 4 a trajectory point
               ops=work + 80 * obs.shape[0] + 4 * traj[-1].numel(),
               tiles_visited={"mean": mean, "max": most},
               library=("no single call", None),
               plain_ms=cuda_ms(torch, plain, reps=5, warmup=1), max_abs_err=0.0)
    rec["ms"] = cuda_ms(torch, rec["call"], reps=20)
    return rec


def lf_phases(torch, ops, clocks, sw, x, y, thr):
    """Kernel (h)'s cycles a phase from its clock build (``kh_clock`` of
    ``clocks``, ``glue_clock_builds``: thread 0 of each CTA stamps its
    phases), as ``kernel_ab.kh_phases`` gives them, and the latency bound's
    cycles: the rounds' dependent chain, warp 0's group's products and
    update a round (the mean over the CTAs) each round."""
    from mpc_mmd_tpu_torch.utils import kernel_ab
    got = kernel_ab._clock_regions(clocks["kh_clock"], "kh_clock",
                                   lambda: ops.local_frame(sw, x, y, thr,
                                                           lib=clocks["kh_clock"]),
                                   entry=kernel_ab.GLUE_CLOCK_ENTRY)
    out = kernel_ab.kh_phases(got["cycles"], sw.maxiter)
    return out, sw.maxiter * (out["products a round"] + out["update a round"])


def check_local_frame(torch, ops, dev, per_step, clocks):
    """Kernel (h) (``ops.local_frame``, ``csrc/local_frame.cu``) against its
    plain version, the chain ``frenet.smooth_path`` then
    ``frenet.path_parameters`` on the card, and against its twin
    (``local_frame_twin``): every output bit-equal (NaN to NaN) on
    ``kernel_ab.kh_window``'s windows (the curved, straight and circuit
    routes near three points, at num_path 600 and 64, one and ten
    rounds), on windows with a NaN waypoint, and on the closed loop's
    window (``kernel_ab.kh_closedloop``: local_problem's 150 m along the
    curved route).  ``per_step``: {path: launches a closed-loop step};
    ``clocks``: ``glue_clock_builds``' builds.  Returns the closed-loop
    shape's record, num_path 64 under ``cases``."""
    from mpc_mmd_tpu_torch import onroad_workload
    from mpc_mmd_tpu_torch.frenet import build_smoother, path_parameters, smooth_path
    from mpc_mmd_tpu_torch.ops.local_frame import local_frame_twin
    from mpc_mmd_tpu_torch.utils.kernel_ab import (KH_AT, KH_ROUNDS, KH_ROUTES, KH_WIDTHS,
                                                   kh_closedloop, kh_window)
    cfg = onroad_workload()
    thr = cfg.frenet.smooth_threshold
    chain = lambda sw, x, y: path_parameters(*smooth_path(sw, x, y, thr))

    def held(sw, x, y, label):
        got = ops.local_frame(sw, x, y, thr)
        ref = chain(sw, x, y)
        twin = local_frame_twin(sw, x, y, thr)
        torch.cuda.synchronize()
        for field, g, r, t in zip(ref._fields, got, ref, twin):
            for what, v in (("kernel (h)", g), ("its twin", t)):
                bad = _bits_apart(v, r)
                if bad:
                    fail(f"{what}: {field} not bit-equal to the chain at {bad} entries, "
                         f"{label}")
        return got

    windows = [(f"{r} near point {at}, num_path {n}", *kh_window(r, at, n, dev))
               for r in KH_ROUTES for at in KH_AT for n in KH_WIDTHS]
    for where in (37, 599):
        x, y = kh_window("curved", 4000, 600, dev)
        x[where] = float("nan")
        windows.append((f"curved near point 4000 with a NaN waypoint at {where}", x, y))
    for label, x, y in windows:
        for rounds in KH_ROUNDS:
            held(build_smoother(x.shape[0], maxiter=rounds, device=dev), x, y,
                 f"{label}, {rounds} rounds")
    sw, x, y = kh_closedloop(cfg, dev)
    n = x.shape[0]
    held(sw, x, y, "the closed loop's window")
    log(f"kernel (h) local_frame: {len(windows) * len(KH_ROUNDS)} windows and the closed "
        f"loop's bit-equal to the chain (smooth_path, path_parameters) and to its twin, "
        f"NaN to NaN")
    cases = []
    sw64 = build_smoother(64, device=dev)
    x64, y64 = kh_window("curved", 4000, 64, dev)
    for label, (s_, xx, yy), at in (
            (f"the closed loop's window, num_path {n}", (sw, x, y), per_step),
            ("a curved window, num_path 64", (sw64, x64, y64), None)):
        m, rounds = xx.shape[0], s_.maxiter
        phases, chain_cycles = lf_phases(torch, ops, clocks, s_, xx, yy, thr)
        got = ops.local_frame(s_, xx, yy, thr)
        cases.append(dict(
            shape=f"{label}: {rounds} rounds",
            call=(lambda a=(s_, xx, yy): ops.local_frame(*a, thr)),
            match="local_frame_kernel", launches_per_solve=at, cold=True,
            phases=phases,
            # the latency bound: the rounds' dependent chain, a group's
            # products and update a round, at the card's highest SM clock
            latency_bound_ms=chain_cycles / sm_clock_max_mhz() / 1e3,
            # K^-1's kept rows read once, the waypoints in, six outputs;
            # two fused multiply-adds a term a row a round, about 150
            # operations a row's update (atan2f, cosf, sinf), 50 a point's
            # path parameters (sqrtf, powf, the quotient)
            nbytes=4 * m * (m + 1) + f32_bytes(xx, yy, *got[:6]),
            ops=4 * rounds * m * (m + 1) + 150 * rounds * m + 50 * m,
            library=("no single call: torch.mv is one of the 2 maxiter products, "
                     "the rounds' updates and the path parameters are not one call", None),
            plain_ms=cuda_ms(torch, lambda a=(s_, xx, yy): chain(*a), reps=5, warmup=1)))
    main = dict(cases[0], max_abs_err=0.0, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"], reps=20)
    return main


# Kernel (c)'s device ms a launch before its cluster redesign (one block of
# 8 warps a candidate, commit e0e38dc; kernel_ab's kc_before at these
# shapes, NVIDIA H100 80GB HBM3 at 700 W): constants from an earlier run,
# logged in 3b as "was" beside this run's time and kept out of the kernels
# record, which holds only this run's measurements
KC_WAS_MS = {(64, 64, 100, 10, 12, "laplace"): 0.9056, (100, 100, 100, 10, 20, "laplace"): 2.2894,
             (100, 100, 16, 4, 20, "laplace"): 0.6548, (100, 100, 25, 5, 20, "laplace"): 0.8305,
             (100, 100, 225, 15, 20, "laplace"): 5.9785, (256, 64, 100, 10, 12, "laplace"): 1.8006,
             (512, 64, 100, 10, 12, "laplace"): 3.5956}


def measure(torch, name, rec):
    """Adds to a kernel's check result its device time per launch, its bound
    and its library call's device time, and logs them; the same for each of
    its ``cases`` (K1's and K2's other path shapes)."""
    for case in rec.get("cases", [rec]):
        case["device_ms"], names = profiled_ms(torch, case["call"], match=case["match"])
        if case.get("cold"):
            # the same launches with a 64 MB buffer (past the 50 MB L2) written
            # before each
            flush = torch.empty(16 * 2 ** 20, device="cuda")
            case["l2_cold_ms"] = profiled_ms(
                torch, lambda c=case: (flush.fill_(1.0), c["call"]()), match=case["match"])[0]
        case["bound_ms"], case["bound_by"] = bound(case["nbytes"], case["ops"],
                                                   case.get("int_ops", 0))
        if "full_scan_ops" in case:
            case["full_scan_bound_ms"] = bound(case["nbytes"], case["full_scan_ops"])[0]
        what, lib = case["library"]
        # a library call named by its kernel is held to one device event a
        # call (``profiled_ms``'s retries); unnamed, every event counts
        case["library_ms"] = (profiled_ms(torch, lib, match=case.get("library_match"),
                                          least=1)[0]
                              if lib else None)
        per_solve = case.get("launches_per_solve")
        log(f"{name} at {case['shape']}: device {case['device_ms']:.4f} ms per launch "
            f"({names[0][:60]}), bound {case['bound_ms']:.4f} ms by {case['bound_by']} "
            f"({case['nbytes'] / 1e6:.2f} MB, {case['ops']:.3g} ops"
            + (f", {case['int_ops']:.3g} integer ops" if case.get("int_ops") else "")
            + "), "
            f"{100 * case['bound_ms'] / case['device_ms']:.1f} % of it; library "
            f"{what}: {case['library_ms']}"
            + (f"; launches per solve {per_solve}" if per_solve else "")
            + (f"; L2-cold {case['l2_cold_ms']:.4f} ms" if "l2_cold_ms" in case else "")
            + (f"; latency bound {case['latency_bound_ms']:.4f} ms"
               if "latency_bound_ms" in case else "")
            + (f"; cycles a phase {case['phases']}" if case.get("phases") else "")
            + (f"; tiles visited a point {case['tiles_visited']}"
               if "tiles_visited" in case else "")
            + (f"; the full scan's bound {case['full_scan_bound_ms']:.4f} ms"
               if "full_scan_bound_ms" in case else "")
            + (f"; was {case['was_device_ms']:.4f} ms (KC_WAS_MS, an earlier run's)"
               if case.get("was_device_ms") else ""))
    for key in ("device_ms", "bound_ms", "bound_by", "library_ms", "l2_cold_ms",
                "tiles_visited", "full_scan_bound_ms"):
        if key in rec.get("cases", [rec])[0]:
            rec[key] = rec.get("cases", [rec])[0][key]


def kernel_record(ops, launches, per_solve, floor_ms, k1, k2, k3, k4, k5, k2t,
                  kd, kp, kb, kc, kd_, ke_, k4n, kf, kg, ks, ko, kh, kc_forms):
    """The kernels' JSON record (see the module docstring); ``k4`` is the
    pair (main path shape, validator shape), ``kd`` kernel (a)'s record,
    ``kp`` its plan form's,
    ``kd_``, ``ke_`` kernel (d)'s and (e)'s and ``k4n``, ``kf``, ``kg``
    K4n's and kernel (f)'s and (g)'s, ``ks``, ``ko`` (g)'s state and
    obstacle forms', ``kh`` kernel (h)'s, ``kc_forms`` kernel (c)'s by form
    (``check_inner_cem``): "inner_cem" counts the launches of every form,
    ``inner_cem_fused``, ``_xt`` and ``_g`` those of their form.  The draw
    kernels replace no TPU kernel: ``replaces`` names the JAX package's
    draw site and the XLA lowering they stand for."""
    record = []
    for fn, src_file, tpu, (rec, largest) in (
            (ops.topk_indices, "topk.cu", "mpc_mmd_tpu/ops/topk_pallas.py:116",
             (k1, None)),
            (ops.eq_qp_solve, "eq_qp.cu", "mpc_mmd_tpu/ops/qp_pallas.py:109",
             (k2, None)),
            (ops.topk_kernel_matrices, "topk_kernel.cu",
             "mpc_mmd_tpu/ops/topk_kernel_pallas.py:87", (k3, None)),
            (ops.fused_rollout, "rollout.cu",
             "mpc_mmd_tpu/ops/rollout_pallas.py:101", k4),
            (ops.topk_onehot, "topk.cu", "mpc_mmd_tpu/ops/topk_pallas.py:146",
             (k5, None)),
            (ops.eq_qp_solve_t, "eq_qp.cu", "mpc_mmd_tpu/ops/qp_pallas.py:85",
             (k2t, None)),
            (ops.prng_draws, "prng.cu", "mpc_mmd_tpu/dynamics.py:91 (jax.random.normal "
             "through XLA's threefry2x32, jax/_src/prng.py:1092; no Pallas kernel)",
             (kd, None)),
            (ops.prng_plan, "prng.cu", "mpc_mmd_tpu/solver.py:186,299 and "
             "solver_frenet.py:56-58 (a solve's jax.random.normal draws inside its "
             "lax.scan, dynamics.py:91-95, through XLA's threefry2x32; no Pallas "
             "kernel)", (kp, None)),
            (ops.prng_beta, "prng.cu", "mpc_mmd_tpu/dynamics.py:110 (jax.random.beta "
             "through XLA, jax/_src/random.py:1133,1398; no Pallas kernel)",
             (kb, None)),
            (ops.inner_cem, "inner_cem.cu", "mpc_mmd_tpu/reduced_set.py:700 (the inner "
             "beta-CEM's lax.scan, compiled by XLA: _selection_qp :487, "
             "_update_samples :575, _winner :595; no Pallas kernel)", (kc, None)),
            (ops.outer_project, "outer_project.cu", "mpc_mmd_tpu/solver.py:190 (the "
             "outer iteration's compute_guess qp.py:164, project projection.py:104, "
             "controls_from_trajectory dynamics.py:142, compiled by XLA; no Pallas "
             "kernel)", (kd_, None)),
            (ops.outer_tail, "outer_tail.cu", "mpc_mmd_tpu/solver.py:235 (the outer "
             "iteration's risk (mmd_obs, cvar_obs, saa_obs), sorts, lane risks, "
             "scalar_cost and cem_update sampling.py:74 in every mode, "
             "solver_frenet.py:199; compiled by XLA; no Pallas kernel)", (ke_, None)),
            (ops.noisy_rollout, "rollout.cu", "mpc_mmd_tpu/ops/rollout_pallas.py:101 "
             "(fused_rollout's lanes, with the noisy controls of batched_rollouts, "
             "mpc_mmd_tpu/solver.py:113-121: perturb_controls dynamics.py:78 and the "
             "mother pairing, compiled by XLA)", (k4n, None)),
            (ops.inner_prologue, "inner_prologue.cu", "mpc_mmd_tpu/solver.py:218 (the "
             "refit qp.py:202 and the distance matrices reduced_set.py:425-430 before "
             "the inner CEM, compiled by XLA; no Pallas kernel)", (kf, None)),
            (ops.frenet_points, "frenet_points.cu", "mpc_mmd_tpu/solver_frenet.py:197 "
             "(global_to_frenet_points frenet.py:229 through _nearest :168, compiled by "
             "XLA; no Pallas kernel)", (kg, None)),
            (ops.frenet_states, "frenet_points.cu", "mpc_mmd_tpu/solver_frenet.py:133 "
             "(the noisy initial states' Frenet states, global_to_frenet_state "
             "frenet.py:173 vmapped through _nearest :168, their means and the b_eq "
             "rows :133-138, compiled by XLA; no Pallas kernel)", (ks, None)),
            (ops.frenet_obstacles, "frenet_points.cu", "mpc_mmd_tpu/closedloop.py:268 "
             "(global_to_frenet_obstacle frenet.py:210 through _nearest :168, and "
             "constant_velocity_obstacles dynamics.py:118; no Pallas kernel)", (ko, None)),
            (ops.local_frame, "local_frame.cu", "mpc_mmd_tpu/frenet.py:134 (smooth_path's "
             "lax.scan :111 and path_parameters :148, called at closedloop.py:256-262, "
             "compiled by XLA; no Pallas kernel)", (kh, None)),
            *((getattr(ops, name), src, tpu, (kc_forms[f], None))
              for f, (name, src, tpu) in KC_FORMS.items() if f in kc_forms)):
        name = fn.__name__
        row = {"name": name, "route": "cuda",
               "source": f"mpc_mmd_tpu_torch/csrc/{src_file}", "replaces": tpu,
               "launches": launches[name],
               "launches_per_solve": {p: n[name] for p, n in per_solve.items()
                                      if n.get(name)},
               "max_abs_err": max(rec["max_abs_err"],
                                  largest["max_abs_err"] if largest else 0.0),
               "shape": rec["shape"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
               "device_ms": rec["device_ms"], "bound_ms": rec["bound_ms"],
               "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
               "library": rec["library"][0], "launch_floor_ms": floor_ms}
        if "cases" in rec:
            row["shapes"] = [{k: c[k] for k in (
                "shape", "device_ms", "l2_cold_ms", "bound_ms", "bound_by", "plain_ms",
                "library_ms", "launches_per_solve", "latency_bound_ms", "phases",
                "tiles_visited", "full_scan_bound_ms", "former_device_ms",
                "former_launches") if k in c}
                for c in rec["cases"]]
        for key in ("tiles_visited", "full_scan_bound_ms"):
            if key in rec:
                row[key] = rec[key]
        if "row_major_gap" in rec:
            row["row_major_gap"] = rec["row_major_gap"]
        if largest:
            row["largest"] = {k: largest[k] for k in (
                "shape", "max_abs_err", "ms", "plain_ms", "device_ms", "bound_ms",
                "bound_by")}
        record.append(row)
    return record


# Work counts of the draw kernels (csrc/prng.cu), for their bounds: about 73
# integer operations a threefry hash (20 rounds of add, rotate, xor and 5 key
# injections); about 50 float32 operations a normal (log1pf, sqrt, the
# erfinv polynomial's 8 fused multiply-adds counted twice).  The Beta
# function's keys and draws depend only on the key, the element and the
# round, so its candidates share them and the bound counts them once a
# (key, element) chain: 2 hashes a key (the root split), 8 a chain outside
# the loops (element keys, each gamma's split and final uniform) with about
# 45 float operations (the final uniforms' log1p), 4 hashes an outer round
# and 3 and a normal an inner one, over the rounds some candidate takes.
# A candidate's own work: about 110 float operations an element (d, c,
# logs, exps, the ratio), 60 an outer round (squeeze and log tests) and 2
# an inner one (the fused multiply-add and its test)
HASH_OPS, NORMAL_OPS = 73, 50
CHAIN_HASHES, CHAIN_OPS = 8, 45
BETA_OPS, OUTER_OPS, INNER_OPS = 110, 60, 2


def ulp_gap(torch, a, b):
    """Largest distance in float32 ulps between two tensors."""
    ia, ib = (t.contiguous().view(torch.int32).to(torch.int64) for t in (a, b))
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def random_keys(torch, gen, dev, K):
    return torch.randint(0, 2 ** 32, (K, 2), generator=gen, device=dev,
                         dtype=torch.int64)


def check_prng_draws(torch, ops, dev, gen, shapes):
    """Kernel (a) against its twin on the card at every path shape
    (``draw_shapes``; the first is fastrt's rollout noise) and at the
    validator's: bits equal, uniforms and normals within 1 ulp (equal but
    where the twin's double-rounded fma meets a tie).  Returns the first
    shape's record, with the others under ``cases``."""
    from mpc_mmd_tpu_torch import prng
    cases, err, worst = [], 0.0, 0
    lib_gen = torch.Generator(device=dev).manual_seed(1)
    for (K, n), at in shapes.items():
        keys = random_keys(torch, gen, dev, K)
        if not torch.equal(ops.prng_draws(keys, n, "bits"), prng.draws(keys, n, "bits")):
            fail(f"prng_draws: bits differ from the twin's at {K} keys x {n}")
        for dist in ("uniform", "normal"):
            got, ref = ops.prng_draws(keys, n, dist), prng.draws(keys, n, dist)
            gap = ulp_gap(torch, got, ref)
            worst = max(worst, gap)
            err = max(err, float((got - ref).abs().max()))
            if gap > 1:
                fail(f"prng_draws: {dist} {gap} ulp from the twin's at {K} keys x {n}")
        cases.append(dict(
            shape=f"{K} keys x {n} normals",
            call=(lambda keys=keys, n=n: ops.prng_draws(keys, n)), match="draws_kernel",
            nbytes=16 * K + 4 * K * n, int_ops=HASH_OPS * K * n, ops=NORMAL_OPS * K * n,
            launches_per_solve=at,
            library=("torch.randn with a generator",
                     lambda K=K, n=n: torch.randn((K, n), generator=lib_gen, device=dev)),
            library_match="distribution_elementwise_grid_stride_kernel",
            plain_ms=cuda_ms(torch, lambda keys=keys, n=n: prng.draws(keys, n), reps=10)))
    torch.cuda.synchronize()
    main = dict(cases[0], max_abs_err=err, ulp=worst, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"])
    return main


def check_prng_plan(torch, ops, dev, plans):
    """Kernel (a)'s plan form at every path's plan (``draw_shapes``; the
    first is fastrt's): the segments of ``JaxNoise.plan`` on a key table
    of the plan's chunk and iterations, each bit-equal to the per-key
    form's draws of its keys (``prng_draws``, kernel against kernel) and
    within 1 ulp of the twin's; the per-key form's launches it replaces
    (``rollout_eps`` and ``cem_z`` an iteration and ``init_state_z``, as
    solves drew them before: (keys, n, launches a solve) under
    ``former``) for phase 15e to time.  Returns the first plan's record,
    with the others under ``cases``."""
    from mpc_mmd_tpu_torch import prng
    from mpc_mmd_tpu_torch.noise import JaxNoise
    noise = JaxNoise(dev)
    cases, worst = [], 0
    lib_gen = torch.Generator(device=dev).manual_seed(1)
    for key, at in plans.items():
        chunk, outer, R, T, n_cem, n_params, n_init = key
        table = noise.keys(list(range(7, 7 + chunk)), outer).to(dev)
        init = None if n_init is None else (noise.init_key(7), n_init)
        segments = noise.plan(table, R, T, n_cem, n_params, init)
        got = ops.prng_plan(segments)
        for (keys, n, dist), view in zip(segments, got):
            flat = keys.reshape(-1, 2)
            if not torch.equal(view.reshape(-1, n), ops.prng_draws(flat, n, dist)):
                fail(f"prng_plan: a segment of {len(flat)} keys x {n} differs from "
                     f"prng_draws' at the plan {key}")
            worst = max(worst, ulp_gap(torch, view.reshape(-1, n), prng.draws(flat, n, dist)))
        if worst > 1:
            fail(f"prng_plan: {worst} ulp from the twin's at the plan {key}")
        former = [(chunk, n_cem * n_params, outer)]
        if R is not None:
            former.append((3 * chunk, R * T, outer))
        if init is not None:
            former.append((1, n_init * 4, 1))
        total = sum(keys[..., 0].numel() * n for keys, n, _ in segments)
        n_keys = sum(keys[..., 0].numel() for keys, _, _ in segments)
        cases.append(dict(
            shape=(f"chunk {chunk} x {outer} iterations: "
                   + ", ".join(f"{keys[..., 0].numel()} keys x {n}" for keys, n, _ in segments)
                   + f" ({total} normals)"),
            call=(lambda s=segments: ops.prng_plan(s)), match="plan_kernel", cold=True,
            nbytes=16 * n_keys + 4 * total, int_ops=HASH_OPS * total,
            ops=NORMAL_OPS * total, launches_per_solve=at, former=former,
            former_launches=sum(count for _, _, count in former),
            library=("torch.randn of as many normals with a generator",
                     lambda total=total: torch.randn(total, generator=lib_gen, device=dev)),
            library_match="distribution_elementwise_grid_stride_kernel",
            plain_ms=cuda_ms(torch, lambda s=segments: prng.plan(s), reps=5)))
    torch.cuda.synchronize()
    main = dict(cases[0], max_abs_err=0.0, ulp=worst, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"])
    return main


def check_prng_beta(torch, ops, dev, gen, shapes):
    """Kernel (b) against its twin on the card at every path shape (the
    first is Path A's): Beta draws within rtol 1e-5 + atol 1e-6, with the
    parameters of a solve (2 and 5 times a 1e-8-floored |u|, u = 0 at the
    first step) and the rejection rounds of this data, counted by the
    twin, in the bound (the shared key chains' rounds once, see
    ``CHAIN_HASHES``).  Returns the first shape's record, with the others
    under ``cases``."""
    from mpc_mmd_tpu_torch import prng
    cases, err, flips = [], 0.0, 0
    for (K, B, n, P), at in shapes.items():
        keys = random_keys(torch, gen, dev, K)
        u = 0.6 * torch.rand((K, B, P), generator=gen, device=dev)
        u[..., 0] = 0.0
        alpha, beta = (c * (u + 1e-8) for c in (2.0, 5.0))
        got = ops.prng_beta(keys, alpha, beta, n)
        tally = {}
        ref = prng.beta_draws(keys, alpha, beta, n, tally)
        d = (got - ref).abs()
        bad = d > 1e-5 * ref.abs() + 1e-6
        if bool(bad.any()) or not bool(got.isfinite().all()):
            at_bad = bad.nonzero()[:4].tolist()
            fail(f"prng_beta: {int(bad.sum())} draws outside rtol 1e-5 + atol 1e-6 "
                 f"of the twin at {K} keys x {B} x {n}: at {at_bad} kernel "
                 f"{[float(got[tuple(i)]) for i in at_bad]}, twin "
                 f"{[float(ref[tuple(i)]) for i in at_bad]}, alpha "
                 f"{[float(alpha[i[0], i[1], i[2] % P]) for i in at_bad]}")
        err, flips = max(err, float(d.max())), flips + int((d > 1e-3).sum())
        elems, chains = K * B * n, K * n
        inner, inner_chains = tally.get("inner", 0), tally.get("inner_chains", 0)
        hashes = (2 * K + CHAIN_HASHES * chains + 4 * tally["outer_chains"]
                  + 3 * inner_chains)
        shape = (2, K, B, n)
        a_full = torch.stack((alpha, beta))[:, :, :, None, :].expand(
            2, K, B, n // P, P).reshape(shape).contiguous()
        cases.append(dict(
            shape=f"{K} keys x {B} x {n}, P = {P} (rounds an element: "
                  f"{tally['outer'] / elems:.3f} outer, {inner / elems:.3f} inner, "
                  f"both gammas; a chain {tally['outer_chains'] / chains:.3f} / "
                  f"{inner_chains / chains:.3f})",
            call=(lambda keys=keys, a=alpha, b=beta, n=n: ops.prng_beta(keys, a, b, n)),
            match="beta_", nbytes=16 * K + 8 * K * B * P + 4 * elems,
            int_ops=HASH_OPS * hashes,
            ops=BETA_OPS * elems + OUTER_OPS * tally["outer"] + INNER_OPS * inner
            + CHAIN_OPS * chains + NORMAL_OPS * inner_chains,
            launches_per_solve=at,
            library=("torch._standard_gamma of both halves' parameters",
                     lambda a=a_full: torch._standard_gamma(a)),
            library_match="gamma_cuda_kernel",
            plain_ms=cuda_ms(torch, lambda keys=keys, a=alpha, b=beta, n=n:
                             prng.beta_draws(keys, a, b, n), reps=3, warmup=1)))
    torch.cuda.synchronize()
    main = dict(cases[0], max_abs_err=err, flips=flips, cases=cases)
    main["ms"] = cuda_ms(torch, main["call"])
    return main


def path_draws(torch, ops, dev, cfg, draw_at, beta_at, plan_at):
    """Phase 15: the JAX key chain's draws on the card (see the module
    docstring).  Returns the records of kernel (a), its plan form and
    kernel (b)."""
    from mpc_mmd_tpu_torch import Solver
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(15)

    # a, b. both kernels against their twins at every path shape
    kd = check_prng_draws(torch, ops, dev, gen, draw_at)
    log(f"15a: prng_draws against its twin at {sorted(draw_at)} (keys, n): bits equal, "
        f"uniforms and normals within {kd['ulp']} ulp (max abs {kd['max_abs_err']:.3e}); "
        f"{kd['ms']:.4f} ms vs plain {kd['plain_ms']:.4f} ms at {kd['shape']}")
    kp = check_prng_plan(torch, ops, dev, plan_at)
    log(f"15a: prng_plan at {len(plan_at)} path plans: every segment bit-equal to "
        f"prng_draws of its keys, within {kp['ulp']} ulp of the twin; {kp['ms']:.4f} ms "
        f"vs plain {kp['plain_ms']:.4f} ms at {kp['shape']}")
    kb = check_prng_beta(torch, ops, dev, gen, beta_at)
    log(f"15b: prng_beta against its twin at {sorted(beta_at)} (keys, candidates, n, P): "
        f"max abs {kb['max_abs_err']:.3e}, {kb['flips']} accept tests flipped; "
        f"{kb['ms']:.4f} ms vs plain {kb['plain_ms']:.4f} ms at {kb['shape']}")

    # c. both kernels against the JAX package's draws for fixed keys
    with np.load(os.path.join(HERE, "mpc_mmd_tpu_torch", "data",
                              "prng_reference.npz")) as f:
        ref = dict(f)
    keys = torch.as_tensor(ref["keys"], device=dev)
    n = ref["bits"].shape[1]
    if not np.array_equal(ops.prng_draws(keys, n, "bits").cpu().numpy(), ref["bits"]) \
            or not np.array_equal(ops.prng_draws(keys, n, "uniform").cpu().numpy(),
                                  ref["uniform"]):
        fail("15c: prng_draws' bits or uniforms differ from the JAX package's")
    gap = ulp_gap(torch, ops.prng_draws(keys, n).cpu(), torch.as_tensor(ref["normal"]))
    got = ops.prng_beta(torch.as_tensor(ref["beta_keys"], device=dev),
                        torch.as_tensor(ref["beta_alpha"], device=dev),
                        torch.as_tensor(ref["beta_beta"], device=dev),
                        ref["beta"].shape[-1]).cpu().numpy()
    beta_err = float(np.abs(got - ref["beta"]).max())
    log(f"15c: against jax.random's draws for {len(keys)} fixed keys: bits and uniforms "
        f"equal, normals within {gap} ulp; Beta max abs {beta_err:.3e}")
    if gap > 4 or not np.allclose(got, ref["beta"], rtol=1e-5, atol=1e-6):
        fail(f"15c: normals {gap} ulp (> 4) or Beta {beta_err} off the JAX package's")

    # d. the full-width fastrt solve on default noise against the JAX solve:
    # the first solve captures the graph, the second replays it
    solver = Solver(cfg, device=dev)
    xo, yo = (torch.as_tensor(ref[k], device=dev) for k in ("solve_x_obs", "solve_y_obs"))
    idx = int(ref["solve_idx"])
    first = solver.solve(idx, INIT, MEAN, COV, xo, yo, 15.0)
    r = solver.solve(idx, INIT, MEAN, COV, xo, yo, 15.0)
    if [g["replays"] for g in solver.graph_stats()] != [1] or not all(
            torch.equal(a, b) for a, b in zip(first, r)):
        fail(f"15d: the second solve is not a replay of the first's graph with its "
             f"bits ({solver.graph_stats()})")
    acc, steer = controls(solver.ws, cfg, r.cx, r.cy)
    ctrl = max(float(np.abs(acc.cpu().numpy() - ref["solve_acc"]).max()),
               float(np.abs(steer.cpu().numpy() - ref["solve_steer"]).max()))
    log(f"15d: fastrt mmd_opt at full width, idx_mpc {idx}, default noise, a graph "
        f"replay, against the JAX package's solve: controls max diff {ctrl:.3e}; cost "
        f"per outer iteration "
        f"card {np.round(r.res.cpu().numpy(), 2).tolist()}, JAX "
        f"{np.round(ref['solve_res'], 2).tolist()}; risk_obs {float(r.risk_obs):.4f} vs "
        f"{float(ref['solve_risk_obs']):.4f}")
    if not ctrl <= 1e-3:
        fail(f"15d: the controls differ from the JAX package's by {ctrl} (> 1e-3)")

    # e. device times, bounds and library calls; the solves and the validator
    # on the new draws
    measure(torch, "prng_draws", kd)
    measure(torch, "prng_plan", kp)
    for case in kp["cases"]:
        # each former launch shape timed alone (one device event a call),
        # times its launches a solve
        case["former_device_ms"] = sum(
            count * profiled_ms(torch, lambda k=random_keys(torch, gen, dev, K), n=n:
                                ops.prng_draws(k, n), match="draws_kernel")[0]
            for K, n, count in case["former"])
        log(f"15e: the {case['former_launches']} per-iteration draws the plan replaces "
            f"at {case['shape']} ({case['former']}: keys, n, launches): "
            f"{case['former_device_ms']:.4f} ms device time a solve, against "
            f"{case['device_ms']:.4f} ms in one plan launch")
    kp["former_device_ms"] = kp["cases"][0]["former_device_ms"]
    measure(torch, "prng_beta", kb)
    lat = {k: [round(1e3 * x, 1) for x in v] for k, v in TIMES.items()
           if k.startswith(("fastrt (", "Path A ("))}
    log(f"15e: on the JAX key chain's draws: the validator at 1200 x 1000 in "
        f"{1e3 * TIMES['validator_1200']:.1f} ms (30-98 ms with the former "
        f"per-row draws, PERF.md); solve latencies (ms) {lat}")
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")
    return kd, kp, kb


def obstacle_scenarios(torch, n, num_obs, tot_time, blocking=False):
    """bench.py's static scenarios (obstacles on a 35-75 m grid in either
    lane), or with ``blocking`` the tie-free near-field ones of
    tests/conftest.py; trajectories (num_obs, num) on tot_time's device."""
    from mpc_mmd_tpu_torch.dynamics import constant_velocity_obstacles
    rng = np.random.default_rng(0)
    grid = np.array([35, 40, 45, 50, 55, 60, 65, 70, 75], np.float32)
    zeros = torch.zeros(num_obs, device=tot_time.device)
    out = []
    for i in range(n):
        if blocking:
            x0 = np.resize([8.0 + 0.37 * i, 13.0 + 0.53 * i], num_obs)
            y0 = np.resize([1.75 - 0.11 * i, 0.6 + 0.13 * i], num_obs)
        else:
            x0 = rng.choice(grid, num_obs, replace=False)
            y0 = rng.choice(np.array([-1.75, 1.75]), num_obs)
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                         device=tot_time.device)
        xt, yt, _ = constant_velocity_obstacles(as_t(x0), as_t(y0), zeros,
                                                zeros, zeros, tot_time)
        out.append((xt, yt))
    return out


INIT = [0.0, 1.75, 5.0, 0.0, 0.0, 0.0]
MEAN = [15.0] * 4 + [0.0] * 4
COV = np.diag([20.0] * 4 + [100.0] * 4)


def check_solve(result, cfg):
    for name in ("cx", "cy"):
        t = getattr(result, name)
        if tuple(t.shape) != (cfg.horizon.nvar,) or not bool(t.isfinite().all()):
            fail(f"solve returned {name} of shape {tuple(t.shape)} with "
                 f"non-finite values")
    if not math.isfinite(float(result.risk_obs)):
        fail(f"solve returned risk_obs {float(result.risk_obs)}")
    s = float(result.beta.sum())
    if abs(s - 1.0) > 1e-3:
        fail(f"sum(beta) = {s}, not 1 within 1e-3")


def cuda_vs_cpu(torch, cfg1, args, label):
    """One outer iteration on the card and on the CPU with identical draws
    (Beta draws recorded on the CPU and replayed on the card)."""
    from mpc_mmd_tpu_torch import Solver
    from mpc_mmd_tpu_torch.noise import FixedNoise, JaxNoise, record_solve_draws
    arrays, record = record_solve_draws(JaxNoise("cpu"), cfg1, 5)
    out = {}
    for name in ("cpu", "cuda"):
        s = Solver(cfg1, device=name, noise=FixedNoise(arrays, name, record))
        res = s.solve(5, *args)
        out[name] = (s.ws, [t.cpu() for t in (res.cx, res.cy)],
                     float(res.risk_obs))
    ws_cpu = out["cpu"][0]
    (cxg, cyg), (cxc, cyc) = out["cuda"][1], out["cpu"][1]
    ag, sg = controls(ws_cpu, cfg1, cxg, cyg)
    ac, sc = controls(ws_cpu, cfg1, cxc, cyc)
    ctrl_err = max(float((ag - ac).abs().max()), float((sg - sc).abs().max()))
    scale = max(1.0, float(cxc.abs().max()), float(cyc.abs().max()))
    coef_err = max(float((cxg - cxc).abs().max()), float((cyg - cyc).abs().max()))
    log(f"{label} cuda vs cpu, one outer iteration: controls max diff "
        f"{ctrl_err:.3e}, coefficients max diff {coef_err:.3e} (scale "
        f"{scale:.1f}), risk_obs {out['cuda'][2]:.6f} vs {out['cpu'][2]:.6f}")
    if not ctrl_err <= 1e-3:
        fail(f"{label}: controls differ between cuda and cpu by {ctrl_err} (> 1e-3)")
    if not coef_err <= 1e-3 * scale:
        fail(f"{label}: coefficients differ between cuda and cpu by {coef_err} "
             f"(> 1e-3 x {scale})")


def timed_solves(torch, ops, solver, cfg, calls, label, path_kernels):
    """Runs ``calls`` (seed, scenario) solves with the launch counts set to 0
    just before and read just after; checks each solve and that every
    kernel of ``path_kernels`` was launched.  Returns the counts."""
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    t0 = time.perf_counter()
    for seed, args in calls:
        ts = time.perf_counter()
        r = solver.solve(seed, *args)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - ts)
        check_solve(r, cfg)
    rate = len(calls) / (time.perf_counter() - t0)
    TIMES[label] = lat
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    missing = [fn.__name__ for fn in path_kernels if launches[fn.__name__] < 1]
    if missing:
        fail(f"{label}: kernels of the path not launched: {missing}; {launches}")
    per_solve = {k: v / len(calls) for k, v in launches.items() if v}
    log(f"{label}: {rate:.2f} solves/s, latencies "
        f"{[round(1e3 * x, 1) for x in lat]} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; launches per "
        f"solve {per_solve}; last risk_obs {float(r.risk_obs):.4f}")
    return launches


def traced(fn):
    """``fn()`` under ``torch.profiler`` (``device_trace``): returns its
    result, the trace summary (wall ms, device busy ms, idle share, device
    events, top kernels) and the profiler."""
    from mpc_mmd_tpu_torch.utils.observability import device_trace
    with tempfile.TemporaryDirectory() as trace_dir:
        with device_trace(trace_dir) as prof:
            r = fn()
        with open(glob.glob(os.path.join(trace_dir, "summary_*.json"))[0]) as f:
            summary = json.load(f)
    return r, summary, prof


def trace_path_a(torch, ops, solver, cfg, call):
    """One Path A fused solve under ``torch.profiler``: device busy ms, idle
    share and the device ms per solve of its inner CEM's kernel (kernel
    (c)'s fused form, or K3 where the chain runs)."""
    r, summary, prof = traced(lambda: solver.solve(call[0], *call[1]))
    check_solve(r, cfg)
    on_kc = "inner_cem" in inner_launches(cfg, "fused")
    name = "inner_cem_kernel" if on_kc else "topk_kernel_matrices_kernel"
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    ev_ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    n = cfg.cem.maxiter_cem * (1 if on_kc else cfg.beta_cem.maxiter)
    # the launches themselves are counted exactly by the wrapper (the path's
    # check); the profiler may drop a record, never add one
    if not n <= 2 * len(ev) <= 2 * n:
        fail(f"Path A trace: {len(ev)} {name} device events in one solve of "
             f"{n} launches")
    log(f"Path A fused, one solve under torch.profiler: {summary['wall_ms']:.1f} ms "
        f"wall, device busy {summary['device_busy_ms']:.2f} ms, idle share "
        f"{summary['idle_share']:.3f}, {summary['device_events']} device events; "
        f"{name} {ev_ms:.3f} ms over {len(ev)} launches (the fused chain, K3 and its "
        f"glue, in PERF.md: busy 45.2 ms, K3 9.1 ms over 400); top "
        f"{summary['top'][:4]}")


def controls(ws, cfg, cx, cy):
    from mpc_mmd_tpu_torch.dynamics import controls_from_trajectory
    T = cfg.horizon.num_prime
    a, s = controls_from_trajectory((ws.Pdot @ cx)[None], (ws.Pdot @ cy)[None],
                                    (ws.Pddot @ cx)[None], (ws.Pddot @ cy)[None],
                                    cfg.horizon.dt, cfg.vehicle.wheel_base)
    return a[0, :T], s[0, :T]


def counted(torch, ops, label, path_kernels, fn):
    """Runs ``fn()`` with the launch counts set to 0 just before and read
    just after, and the peak memory reset; fails unless every kernel of
    ``path_kernels`` was launched.  Returns (result, seconds, launches)."""
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in ops.KERNELS}
    missing = [f.__name__ for f in path_kernels if launches[f.__name__] < 1]
    if missing:
        fail(f"{label}: kernels of the path not launched: {missing}; {launches}")
    return out, secs, launches


SWEEP_FLAGS = ["--workload", "static", "--noise_levels", "0.1", "--noises",
               "gaussian", "--num_reduced_sets", "10", "--num_obs", "6",
               "--num_prime", "50", "--num_configs", "40", "--chunk", "20",
               "--outer_budget", "64x10", "--inner_budget", "64x12",
               "--dispatch", "pipeline", "--device", "cuda"]


def path_c(torch, ops, dev, work, per_solve):
    """Phase 9: sweep, resume, validate, the validator at 1200 solves, card
    vs CPU, and the gaussian / matern52 kernels.  Returns the launch counts
    of the path's runs and {mode: (store root, seconds)} of its sweeps;
    adds the sweeps' launches per solve and the validator's per 1200
    validations to ``per_solve``."""
    from mpc_mmd_tpu_torch import Solver, fastrt_workload
    from mpc_mmd_tpu_torch.cli import sweep as sweep_cli
    from mpc_mmd_tpu_torch.cli import validate as validate_cli
    from mpc_mmd_tpu_torch.noise import FixedNoise, JaxNoise
    from mpc_mmd_tpu_torch.qp import build_workspace
    from mpc_mmd_tpu_torch.utils.io_store import ResultStore
    from mpc_mmd_tpu_torch.utils.observability import device_trace
    from mpc_mmd_tpu_torch.validate import CHUNK, make_validator

    KC, K4, KF = ops.inner_cem, ops.noisy_rollout, ops.inner_prologue
    D, P, B = ops.prng_draws, ops.prng_plan, ops.prng_beta
    data = os.path.join(work, "data")
    path_launches, roots, sweeps = [], {}, {}

    # a. the sweep CLI, one mode per command
    for mode in ("mmd_opt", "cvar"):
        _, secs, got = counted(
            torch, ops, f"Path C sweep {mode}",
            (KC, KF, K4, P) if mode == "mmd_opt" else (K4, P),
            lambda: sweep_cli.main(["--costs", mode, "--out", data, *SWEEP_FLAGS]))
        found = glob.glob(os.path.join(data, "static", "*", "*", "*", f"{mode}_*"))
        if len(found) != 1:
            fail(f"Path C sweep {mode}: expected one store, found {found}")
        roots[mode] = found[0]
        store = ResultStore(roots[mode])
        arrays = store.concatenated()
        if store.done_chunks() != [0, 1] or not np.all(np.isfinite(arrays["cx"])):
            fail(f"Path C sweep {mode}: chunks {store.done_chunks()}, or "
                 "non-finite coefficients")
        log(f"Path C sweep {mode} (static, gaussian 0.1, fastrt budgets, 40 "
            f"scenarios, pipeline): {secs:.2f} s, {40 / secs:.2f} solves/s, "
            f"accepted {len(arrays['cx'])}/40, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; launches {got}")
        path_launches.append(got)
        per_solve[f"sweep_{mode}"] = {k: v / 40 for k, v in got.items()}
        sweeps[mode] = (roots[mode], secs)

    # b. the same commands again: every chunk resumes, nothing is solved
    chunk_files = {r: sorted(os.listdir(r)) for r in roots.values()}
    stamps = {r: [os.stat(os.path.join(r, f)).st_mtime_ns for f in chunk_files[r]]
              for r in roots.values()}
    _, secs, got = counted(torch, ops, "Path C resume", (), lambda: [
        sweep_cli.main(["--costs", m, "--out", data, *SWEEP_FLAGS]) for m in roots])
    if any(got.values()) or any(
            sorted(os.listdir(r)) != chunk_files[r]
            or [os.stat(os.path.join(r, f)).st_mtime_ns for f in chunk_files[r]]
            != stamps[r] for r in roots.values()):
        fail(f"Path C resume: the rerun solved or rewrote something ({got})")
    log(f"Path C resume: both sweeps again in {secs:.2f} s, no solve, no launch")

    # c. paired validation of the two modes
    res, secs, got = counted(
        torch, ops, "Path C validate_compare", (ops.fused_rollout, D),
        lambda: validate_cli.validate_compare(
            [roots["mmd_opt"], roots["cvar"]], n_mc=1000, seed=0,
            out_root=os.path.join(work, "stats"), device=dev))
    if res["n_common"] < 1:
        fail("Path C validate_compare: no scenario accepted by both modes")
    pair = res["pairs"]["mmd_opt_vs_cvar"]
    log(f"Path C validate_compare at n_mc=1000: n_common {res['n_common']}, "
        f"collision % mmd_opt {res['modes']['mmd_opt']['coll_pct_mean']:.4f}, "
        f"cvar {res['modes']['cvar']['coll_pct_mean']:.4f}, Wilcoxon p "
        f"{pair['p_wilcoxon']}; {secs:.2f} s; launches {got}")
    path_launches.append(got)

    # d. dynamic cut-in cvar sweep (every solve kept) and its validation
    dyn, secs, got = counted(
        torch, ops, "Path C dynamic sweep", (K4, P, B),
        lambda: sweep_cli.run_sweep("dynamic", "cvar", "beta", 0.2, 10, 6, 50,
                                    20, data, chunk=20, dispatch="pipeline",
                                    accept_all=True, device=dev))
    risk = dyn.concatenated()["risk_obs"]
    path_launches.append(got)
    stats, vsecs, got = counted(
        torch, ops, "Path C dynamic validation", (ops.fused_rollout, D, B),
        lambda: validate_cli.validate_store(dyn.root, n_mc=1000, seed=0,
                                            out_root=os.path.join(work, "dyn"),
                                            device=dev))
    if stats["n_solves"] != 20:
        fail(f"Path C dynamic validation: {stats['n_solves']} solves, not 20")
    log(f"Path C dynamic sweep (cut-in, beta 0.2, cvar, 100 x 20 outer): "
        f"{secs:.2f} s, {20 / secs:.2f} solves/s, {int(np.sum(risk <= 1e-5))}/20 "
        f"under the acceptance threshold; validation at n_mc=1000 in "
        f"{vsecs:.2f} s, collision % {stats['coll_pct_mean']:.4f} "
        f"(p95 {stats['coll_pct_p95']:.4f}); launches {got}")
    path_launches.append(got)

    # e. the validator alone over 1200 solves
    store = ResultStore(roots["mmd_opt"])
    cfg = validate_cli.config_of(store.meta)
    arrays = store.concatenated()
    idx = np.resize(np.arange(len(arrays["cx"])), 1200)
    args = [arrays[f][idx] for f in ("cx", "cy")] + [arrays["init_state"][0]] + \
        [arrays[f][idx] for f in ("x_obs_traj", "y_obs_traj")]
    validator = make_validator(cfg, build_workspace(cfg, dev), n_mc=1000)
    validator(*(a[:8] if a.ndim > 1 else a for a in args))        # warm-up
    out, secs, got = counted(
        torch, ops, "Path C validator", (ops.fused_rollout, D),
        lambda: [t.cpu().numpy() for t in validator(*args)])
    n_k4 = -(-1200 // CHUNK)
    if got["fused_rollout"] != n_k4 or got["prng_draws"] != n_k4 or \
            out[0].shape != (1200,) or not (0 <= out[0].min() and out[0].max() <= 1000):
        fail(f"Path C validator: K4 launches {got['fused_rollout']} and draw "
             f"launches {got['prng_draws']} (expected {n_k4} each) or counts out "
             f"of range")
    TIMES["validator_1200"] = secs
    log(f"Path C validator: 1200 solves x 1000 rollouts x 50 steps in "
        f"{secs:.3f} s, {1200 / secs:.1f} validations/s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, {n_k4} K4 "
        f"launches of up to {CHUNK * 1000} lanes; mean collision % "
        f"{out[0].mean() / 10:.4f}")
    path_launches.append(got)
    per_solve["validator_1200"] = dict(got)
    trace_dir = os.path.join(work, "trace")
    with device_trace(trace_dir):
        validator(*args)
    with open(glob.glob(os.path.join(trace_dir, "summary_*.json"))[0]) as f:
        prof = json.load(f)
    k4_ms = sum(ms for name, ms, _ in prof["top"] if "rollout_kernel" in name)
    log(f"Path C validator under torch.profiler: {prof['wall_ms']:.1f} ms wall, "
        f"device busy {prof['device_busy_ms']:.2f} ms (idle share "
        f"{prof['idle_share']:.3f}), {prof['device_events']} device events, "
        f"K4 {k4_ms:.3f} ms; top {prof['top'][:4]}")

    # f. the validator on the card against the CPU, identical draws
    T = cfg.horizon.num_prime
    draws = JaxNoise("cpu").mc_draws(0, range(8), 1000, T)
    arrays8 = dict(zip(("mc_eps_acc", "mc_eps_steer", "mc_eps_const"),
                       (d.numpy() for d in draws)))
    counts = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        v = make_validator(cfg, build_workspace(cfg, device), 1000,
                           FixedNoise(arrays8, device))
        counts[name] = [t.cpu().numpy().astype(np.int64) for t in v(
            *(a[:8] if a.ndim > 1 else a for a in args))[:2]]
    d_coll = np.abs(counts["cuda"][0] - counts["cpu"][0]).max()
    d_lane = np.abs(counts["cuda"][1] - counts["cpu"][1]).max()
    d_pct = abs(counts["cuda"][0].mean() - counts["cpu"][0].mean()) / 10
    log(f"Path C validator cuda vs cpu, 8 solves, identical draws: coll_count "
        f"max diff {d_coll}, lane_count max diff {d_lane}, mean collision % "
        f"{counts['cuda'][0].mean() / 10:.4f} vs {counts['cpu'][0].mean() / 10:.4f}")
    if d_coll > 1 or d_lane > 1 or d_pct > 0.1:
        fail("Path C: the validator on the card disagrees with the CPU beyond "
             "+-1 per solve or 0.1 pp")

    # g. the gaussian and matern52 MMD kernels at the fastrt width
    for kind in ("gaussian", "matern52"):
        cfg_k = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50)
        cfg_k = cfg_k.replace(risk=dataclasses.replace(cfg_k.risk, kernel=kind))
        solver = Solver(cfg_k, device=dev)
        scen = obstacle_scenarios(torch, 1, 6, solver.ws.tot_time)[0]
        r, secs, got = counted(torch, ops, f"Path C {kind} kernel", (KC, KF, K4, P),
                               lambda: solver.solve(0, INIT, MEAN, COV, *scen, 15.0))
        check_solve(r, cfg_k)
        log(f"Path C fastrt mmd_opt, {kind} kernel: {1e3 * secs:.1f} ms (first "
            f"solve), risk_obs {float(r.risk_obs):.4f}; launches {got}")
        path_launches.append(got)
    return path_launches, sweeps


# Path D's world: two obstacles block both lanes 12-18 m ahead, two more
# further on, so every candidate meets a distinct risk
ONROAD_OBSTACLES = ((12.0, 0.5), (18.0, 3.0), (40.0, 0.0), (60.0, 3.5))


def onroad_problem(torch, cfg, dev):
    """Step 0 of an on-road episode, built on the card as ``run_episode``
    builds it: the curved route's waypoint window, smoothed, its path
    parameters, the obstacles in Frenet.  Returns the arguments of
    ``FrenetSolver.solve`` after ``idx_mpc``."""
    from mpc_mmd_tpu_torch.closedloop import (SyntheticPlant, local_problem,
                                              make_route)
    from mpc_mmd_tpu_torch.frenet import build_smoother
    plant = SyntheticPlant(cfg, make_route("curved"), ONROAD_OBSTACLES)
    tot_time = torch.as_tensor(np.linspace(0, cfg.horizon.t_fin, cfg.horizon.num),
                               dtype=torch.float32, device=dev)
    frame, x_obs, y_obs, init = local_problem(
        cfg, plant, build_smoother(cfg.frenet.num_path, device=dev), tot_time)
    return init, MEAN, COV, x_obs, y_obs, 15.0, frame


def check_frenet_solve(r, cfg, label):
    for name, n in (("cx", cfg.horizon.nvar), ("cy", cfg.horizon.nvar),
                    ("v_best", cfg.horizon.num), ("steering_best", cfg.horizon.num)):
        t = getattr(r, name)
        if tuple(t.shape) != (n,) or not bool(t.isfinite().all()):
            fail(f"{label}: {name} of shape {tuple(t.shape)} with non-finite values")
    if not math.isfinite(float(r.risk_obs)):
        fail(f"{label}: risk_obs {float(r.risk_obs)}")


def frenet_cuda_vs_cpu(torch, cfg, dev, args, seed):
    """One outer iteration of ``FrenetSolver`` on the card and on the CPU
    with seed's draws; the largest difference of v_best and steering_best."""
    from mpc_mmd_tpu_torch import FrenetSolver
    from mpc_mmd_tpu_torch.noise import FixedNoise, JaxNoise, record_solve_draws
    cfg1 = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=1))
    arrays, _ = record_solve_draws(JaxNoise("cpu"), cfg1, seed)
    out = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        r = FrenetSolver(cfg1, device=device,
                         noise=FixedNoise(arrays, device)).solve(seed, *args)
        out[name] = [t.cpu() for t in (r.v_best, r.steering_best)]
    return max(float((g - c).abs().max()) for g, c in zip(out["cuda"], out["cpu"]))


def path_d(torch, ops, dev, cfg, per_solve):
    """Phase 10: the on-road stack at full width (see the module
    docstring).  Returns the launch counts of its runs; adds each run's
    launches per solve to ``per_solve``."""
    from mpc_mmd_tpu_torch import FrenetSolver
    from mpc_mmd_tpu_torch.cli import closedloop as closedloop_cli

    K1, K2, K3, K4 = (ops.topk_indices, ops.eq_qp_solve, ops.topk_kernel_matrices,
                      ops.noisy_rollout)
    KC, D, KG = ops.inner_cem, ops.prng_plan, ops.frenet_points
    KD, KE, KS, KO = ops.outer_project, ops.outer_tail, ops.frenet_states, ops.frenet_obstacles
    n_inner = cfg.cem.maxiter_cem * cfg.beta_cem.maxiter
    outer = cfg.cem.maxiter_cem
    draws = loop_launches(cfg, frenet=True)
    args = onroad_problem(torch, cfg, dev)
    path_launches = []

    def expect(got, want, n, label):
        want = {fn.__name__: want.get(fn.__name__, 0) * n for fn in ops.KERNELS}
        if got != want:
            fail(f"{label}: launches {got}, expected {want} ({n} solves)")

    # b. mmd_opt, "xla" selection
    solver = FrenetSolver(cfg, device=dev)
    t0 = time.perf_counter()
    check_frenet_solve(solver.solve(0, *args), cfg, "Path D warm-up")
    torch.cuda.synchronize()
    log(f"Path D warm-up solve: {time.perf_counter() - t0:.2f} s")
    ops.reset_launch_counts()
    lat = []
    for i in (1, 2):
        ts = time.perf_counter()
        r = solver.solve(i, *args)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - ts)
        check_frenet_solve(r, cfg, "Path D mmd_opt")
    got = {fn.__name__: fn.launches for fn in ops.KERNELS}
    expect(got, {"inner_cem": outer, **draws}, 2,
           "Path D mmd_opt xla")
    path_launches.append(got)
    per_solve["path_d_xla"] = {k: v / 2 for k, v in got.items()}
    log(f"Path D (on-road, gaussian 0.1, mmd_opt, xla selection): "
        f"{2 / sum(lat):.2f} solves/s, latencies {[round(1e3 * x, 1) for x in lat]} "
        f"ms; launches per solve {per_solve['path_d_xla']}; last risk_obs "
        f"{float(r.risk_obs):.4f}, v_best[:4] {r.v_best[:4].tolist()}")
    r, summary, _ = traced(lambda: solver.solve(3, *args))
    check_frenet_solve(r, cfg, "Path D traced")
    log(f"Path D mmd_opt xla, one solve under torch.profiler: "
        f"{summary['wall_ms']:.1f} ms wall, device busy "
        f"{summary['device_busy_ms']:.2f} ms, idle share {summary['idle_share']:.3f}, "
        f"{summary['device_events']} device events; top {summary['top'][:5]}")

    # c. the fused selection
    inner_f = inner_launches(cfg, "fused")
    os.environ["MPC_MMD_FUSED_CEM"] = "1"
    r, secs, got = counted(torch, ops, "Path D fused",
                           kernels_of(ops, inner_f) + (K4, KG, KS, D),
                           lambda: solver.solve(4, *args))
    os.environ.pop("MPC_MMD_FUSED_CEM")
    check_frenet_solve(r, cfg, "Path D fused")
    expect(got, {**inner_f, **draws}, 1, "Path D fused")
    path_launches.append(got)
    per_solve["path_d_fused"] = dict(got)
    log(f"Path D mmd_opt, fused selection: {1e3 * secs:.1f} ms (first fused "
        f"solve); launches {got}")

    # d. the other modes, one solve each
    solvers = {}
    for mode in ("cvar", "saa", "mmd_random", "det"):
        cfg_m = cfg.with_risk_mode(mode)
        s = FrenetSolver(cfg_m, device=dev)
        r, secs, got = counted(torch, ops, f"Path D {mode}",
                               (KD, KE, KS, D) if mode == "det" else (KD, KE, K4, KG, KS, D),
                               lambda: s.solve(5, *args))
        solvers[mode] = s
        check_frenet_solve(r, cfg_m, f"Path D {mode}")
        fresh = loop_launches(cfg_m, frenet=True, fresh=True)
        expect(got, fresh, 1,
               f"Path D {mode}")
        path_launches.append(got)
        per_solve[f"path_d_{mode}"] = dict(got)
        log(f"Path D {mode}: {1e3 * secs:.1f} ms (first solve), risk_obs "
            f"{float(r.risk_obs):.4f}; launches {got}")

    # e. one outer iteration of mmd_opt, card against CPU, identical draws:
    # those of seed 1, which must agree, and of seed 5, whose inner CEM
    # meets two samples so close in cost that the summation order of the
    # products decides between them (ROADMAP Queue 3): its reading is
    # logged, not held
    for seed in (1, 5):
        err = frenet_cuda_vs_cpu(torch, cfg, dev, args, seed)
        log(f"Path D cuda vs cpu, one outer iteration of mmd_opt on seed {seed}'s draws: "
            f"v_best and steering_best max diff {err:.3e}"
            + (" (the known near-tie, not held)" if seed == 5 else ""))
        if seed == 1 and not err <= 1e-3:
            fail(f"Path D: the controls differ between cuda and cpu by {err} (> 1e-3)")

    # f. the closed-loop CLI, each step's local_problem under an ATen counter
    from mpc_mmd_tpu_torch import closedloop
    KH = ops.local_frame
    lp_ops = {}
    for mode, kernels in (("mmd_opt", (KC, KD, KE, K4, KG, KS, KO, KH, D)),
                          ("cvar", (KD, KE, K4, KG, KS, KO, KH, D)),
                          ("det", (KD, KE, KS, KO, KH, D))):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), aten_counted(closedloop, "local_problem") as seen:
            results, secs, got = counted(
                torch, ops, f"Path D closed loop {mode}", kernels,
                lambda: closedloop_cli.main(["--mode", mode, "--route", "curved",
                                             "--episodes", "1", "--max_steps", "20"]))
        episode = json.loads(buf.getvalue().splitlines()[0])
        if not {"collided", "steps", "mean_solve_ms", "p99_solve_ms"} <= set(episode):
            fail(f"Path D closed loop {mode}: no episode line ({buf.getvalue()!r})")
        if mode == "det" and {k for k, v in got.items() if v} != {
                D.__name__, ops.prng_draws.__name__, KD.__name__, KE.__name__, KS.__name__,
                KO.__name__, KH.__name__}:
            fail(f"Path D closed loop det launched other kernels than (d), (e), (g)'s "
                 f"state and obstacle forms, (h) and the draws: {got}")
        steps = results[0].steps
        if not got[KS.__name__] == got[KO.__name__] == got[KH.__name__] == got[
                D.__name__] == steps:
            fail(f"Path D closed loop {mode}: not one launch each of (g)'s state and "
                 f"obstacle forms, of (h) and of (a)'s plan form a step of {steps}: {got}")
        if got[KD.__name__] != got[KE.__name__] or got[KE.__name__] != (
                steps * cfg.cem.maxiter_cem):
            fail(f"Path D closed loop {mode}: not one (d) and one (e) an outer iteration "
                 f"of each of {steps} steps: {got}")
        if seen["calls"] != steps or any(seen[op] for op in ("mv", "addmv", "cumsum")):
            fail(f"Path D closed loop {mode}: local_problem ran the smoother's chain "
                 f"({seen['calls']} calls for {steps} steps; ATen {dict(seen)})")
        lp_ops[mode] = (sum(v for k, v in seen.items() if k != "calls") / steps,
                        dict(seen))
        path_launches.append(got)
        per_solve[f"closedloop_{mode}"] = {k: v / steps for k, v in got.items()}
        log(f"Path D closed loop, python -m mpc_mmd_tpu_torch.cli.closedloop --mode "
            f"{mode} --route curved --episodes 1 --max_steps 20: {secs:.2f} s; "
            f"{json.dumps(episode)}; launches {got}; local_problem's ATen operations a "
            f"step {lp_ops[mode][0]:.1f}, no mv, addmv or cumsum")

    # g. local_problem's host ms a step (to torch.cuda.synchronize) with its
    # frame from kernel (h) and from the chain it replaces, in turns; and the
    # closed-loop step a vehicle stack waits for, local_problem then the
    # solve (det and mmd_opt, their graphs captured above), the same way
    from mpc_mmd_tpu_torch.closedloop import SyntheticPlant, local_problem, make_route
    from mpc_mmd_tpu_torch.frenet import build_smoother, path_parameters, smooth_path
    plant = SyntheticPlant(cfg, make_route("curved"), ONROAD_OBSTACLES)
    smoother = build_smoother(cfg.frenet.num_path, device=dev)
    tot = torch.as_tensor(np.linspace(0, cfg.horizon.t_fin, cfg.horizon.num),
                          dtype=torch.float32, device=dev)
    chain = lambda sw, x, y, thr: path_parameters(*smooth_path(sw, x, y, thr))
    with aten_counted(closedloop, "local_problem") as seen_h:
        closedloop.local_problem(cfg, plant, smoother, tot)
    closedloop.local_frame = chain
    try:
        with aten_counted(closedloop, "local_problem") as seen_c:
            closedloop.local_problem(cfg, plant, smoother, tot)
    finally:
        closedloop.local_frame = KH

    def step(s):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame, x_obs, y_obs, init = local_problem(cfg, plant, smoother, tot)
        if s is not None:
            s.solve(7, init, MEAN, COV, x_obs, y_obs, 15.0, frame)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    timed = {}
    try:
        for what, s in (("local_problem", None), ("det step", solvers["det"]),
                        ("mmd_opt step", solver)):
            for label in ("kernel", "chain", "chain", "kernel") * 5:
                closedloop.local_frame = KH if label == "kernel" else chain
                timed.setdefault((what, label), []).append(step(s))
    finally:
        closedloop.local_frame = KH
    p50 = {k: float(np.median(v)) for k, v in timed.items()}
    log(f"Path D g: host ms a step to synchronize (10 each in turns; p50, min), the frame "
        f"from kernel (h) / from the chain: "
        + "; ".join(f"{what} {p50[(what, 'kernel')]:.3f} ({min(timed[(what, 'kernel')]):.3f}) "
                    f"/ {p50[(what, 'chain')]:.3f} ({min(timed[(what, 'chain')]):.3f})"
                    for what in ("local_problem", "det step", "mmd_opt step"))
        + f"; local_problem's ATen operations {sum(v for k, v in seen_h.items() if k != 'calls')}"
        f" with (h), {sum(v for k, v in seen_c.items() if k != 'calls')} with the chain "
        f"(of them mv {seen_c['mv']}, cumsum {seen_c['cumsum']})")
    return path_launches


@contextlib.contextmanager
def aten_counted(module, name):
    """Wraps ``module.name`` for the block: each call runs under a
    TorchDispatchMode that counts its ATen operations by name (the CUDA
    kernels of ``ops`` are launched through ctypes and do not pass the
    dispatcher).  Yields the Counter, with the calls under "calls"."""
    import collections
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = collections.Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[func.overloadpacket.__name__] += 1
            return func(*args, **(kwargs or {}))

    orig = getattr(module, name)

    def watched(*args, **kw):
        seen["calls"] += 1
        with Count():
            return orig(*args, **kw)
    setattr(module, name, watched)
    try:
        yield seen
    finally:
        setattr(module, name, orig)


def stacked(torch, scenarios):
    """(x, y) obstacle trajectories of ``obstacle_scenarios``, stacked."""
    return (torch.stack([x for x, _ in scenarios]),
            torch.stack([y for _, y in scenarios]))


def check_rows(result, cfg):
    """``check_solve`` on every scenario of a ``solve_batch`` result."""
    for i in range(result.cx.shape[0]):
        check_solve(type(result)(*(f[i] for f in result)), cfg)


def without_sync(torch, fn):
    """``fn()`` with CUDA's sync debug mode at "error": any call that would
    synchronise the host with the card raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def path_e(torch, ops, dev, cfg, cfg_a, cfg_d, work, sweeps, per_solve):
    """Phase 11: scenario chunks and the exact strategy (see the module
    docstring).  ``sweeps`` holds Path C's pipeline sweeps.  Returns the
    launch counts of its runs; adds each run's launches per chunk (per
    solve for a chunk of one or a single solve) to ``per_solve``."""
    from mpc_mmd_tpu_torch import FrenetSolver, Solver
    from mpc_mmd_tpu_torch.cli import sweep as sweep_cli
    from mpc_mmd_tpu_torch.scenarios import dynamic_cutin, ego_initial_state
    from mpc_mmd_tpu_torch.utils.io_store import ResultStore

    K1, K2, K3, K4 = (ops.topk_indices, ops.eq_qp_solve, ops.topk_kernel_matrices,
                      ops.noisy_rollout)
    KC, D, B = ops.inner_cem, ops.prng_plan, ops.prng_beta
    names = [fn.__name__ for fn in ops.KERNELS]
    one_solve = {k: round(v) for k, v in per_solve["fastrt"].items()}
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    init, mean, cov = f32(INIT), f32(MEAN), f32(COV)
    path_launches = []

    def expect(got, want, label):
        want = {name: want.get(name, 0) for name in names}
        if got != want:
            fail(f"{label}: launches {got}, expected {want}")

    # a. fastrt solve_batch over 8 static scenarios at chunks of 1, 4 and 8
    solvers, results = {}, {}
    for n in (1, 4, 8):
        solvers[n] = solver = Solver(cfg, device=dev, scenario_chunk=n)
        if n == 1:
            xs, ys = stacked(torch, obstacle_scenarios(
                torch, 8, cfg.obstacles.num_obs, solver.ws.tot_time))
        check_rows(solver.solve_batch(list(range(100, 100 + n)), init, mean, cov,
                                      xs[:n], ys[:n], 15.0), cfg)        # warm-up
        held = torch.cuda.memory_allocated()
        r, secs, got = counted(
            torch, ops, f"Path E chunk {n}", (KC, K4, D),
            lambda: solver.solve_batch(list(range(1, 9)), init, mean, cov, xs, ys,
                                       15.0))
        peak = torch.cuda.max_memory_allocated() - held
        check_rows(r, cfg)
        chunks = 8 // n
        expect(got, {k: chunks * v for k, v in one_solve.items()},
               f"Path E chunk {n} ({chunks} chunks, each one solve's launches)")
        results[n] = r
        per_solve[f"path_e_chunk{n}"] = {k: v / chunks for k, v in got.items()}
        path_launches.append(got)
        log(f"Path E a, fastrt mmd_opt solve_batch over 8 static scenarios at "
            f"scenario_chunk {n}: {8 / secs:.2f} solves/s ({1e3 * secs:.1f} ms), "
            f"peak memory {peak / 2**20:.0f} MiB above the {held / 2**20:.0f} MiB "
            f"held before, launches per chunk "
            f"{per_solve[f'path_e_chunk{n}']} (one solve's: {one_solve})")
    fields = ("cx", "cy", "risk_obs", "res", "mean_param", "cov_param")
    gaps = {n: max(float((getattr(results[n], f) - getattr(results[1], f)).abs().max())
                   for f in fields) for n in (4, 8)}
    log(f"Path E a: the static scenarios at chunks 4 and 8 against chunk 1, largest "
        f"difference in {', '.join(fields)}: {gaps}")
    if any(gaps.values()):
        fail(f"Path E a: a chunk did not give its scenarios the bits of chunk 1: {gaps}")
    # a chunk of 32 (the shared-weight products, the outer CEM's Cholesky,
    # the inner resample hold their bits to 64 scenarios,
    # tests/test_torch_gpu.py): its first, a middle and its last scenario
    # against each solved alone, bit for bit
    big = Solver(cfg, device=dev, scenario_chunk=32)
    x32, y32 = stacked(torch, obstacle_scenarios(torch, 32, cfg.obstacles.num_obs,
                                                 big.ws.tot_time))
    seeds32 = list(range(200, 232))
    t0 = time.perf_counter()
    r32 = big.solve_batch(seeds32, init, mean, cov, x32, y32, 15.0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check_rows(r32, cfg)
    apart = {}
    for i in (0, 15, 31):
        one = solvers[1].solve(seeds32[i], init, mean, cov, x32[i], y32[i], 15.0)
        apart[i] = [f for f in fields if not torch.equal(getattr(r32, f)[i],
                                                         getattr(one, f))]
    log(f"Path E a, fastrt mmd_opt at scenario_chunk 32: {32 / secs:.2f} solves/s "
        f"({1e3 * secs:.1f} ms, first chunk), scenarios 0, 15, 31 against each alone, "
        f"fields with another bit: {apart}")
    if any(apart.values()):
        fail(f"Path E a: the chunk of 32 did not give its scenarios their bits: {apart}")

    # b. each scenario of a chunk of 4 against the same scenario alone, on
    # the tie-free blocking scenarios
    xb, yb = stacked(torch, obstacle_scenarios(
        torch, 4, cfg.obstacles.num_obs, solvers[4].ws.tot_time, blocking=True))
    seeds = [21, 22, 23, 24]
    batch = solvers[4].solve_batch(seeds, init, mean, cov, xb, yb, 15.0)
    worst = {"cx": 0.0, "cy": 0.0, "risk_obs": 0.0}
    for i, seed in enumerate(seeds):
        one = solvers[4].solve(seed, init, mean, cov, xb[i], yb[i], 15.0)
        for name in worst:
            worst[name] = max(worst[name], scaled_gap(getattr(batch, name)[i],
                                                      getattr(one, name)))
    log(f"Path E b, a chunk of 4 blocking scenarios against each solved alone: max "
        f"gap over the scale {worst}")
    if max(worst.values()) > 1e-4:
        fail(f"Path E b: a chunk differs from its scenarios solved alone: {worst}")

    # c. Path A with the fused selection at chunk 4
    init_d, mean_d, cov_d, v_des = ego_initial_state("dynamic")
    cut = dynamic_cutin(cfg_a, 8, device=dev)
    inner_f = inner_launches(cfg_a, "fused")
    os.environ["MPC_MMD_FUSED_CEM"] = "1"
    try:
        sa = Solver(cfg_a, device=dev, scenario_chunk=4)
        check_rows(sa.solve_batch([5, 6, 7, 8], init_d, mean_d, cov_d, cut.x_traj[4:],
                                  cut.y_traj[4:], v_des), cfg_a)        # warm-up
        r, secs, got = counted(
            torch, ops, "Path E fused chunk", kernels_of(ops, inner_f) + (K4, D, B),
            lambda: sa.solve_batch([1, 2, 3, 4], init_d, mean_d, cov_d,
                                   cut.x_traj[:4], cut.y_traj[:4], v_des))
    finally:
        os.environ.pop("MPC_MMD_FUSED_CEM")
    check_rows(r, cfg_a)
    expect(got, {**inner_f, **loop_launches(cfg_a)}, "Path E c, one chunk of 4")
    per_solve["path_e_fused4"] = dict(got)
    path_launches.append(got)
    log(f"Path E c, Path A fused at scenario_chunk 4 (4 cut-in scenarios): "
        f"{4 / secs:.2f} solves/s ({1e3 * secs:.1f} ms a chunk), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; launches {got}")

    # d. Path B cvar at chunk 4
    sb = Solver(cfg_a.with_risk_mode("cvar"), device=dev, scenario_chunk=4)
    check_rows(sb.solve_batch([5, 6, 7, 8], init_d, mean_d, cov_d, cut.x_traj[4:],
                              cut.y_traj[4:], v_des), cfg_a)            # warm-up
    r, secs, got = counted(
        torch, ops, "Path E cvar chunk", (K4, D, B),
        lambda: sb.solve_batch([1, 2, 3, 4], init_d, mean_d, cov_d, cut.x_traj[:4],
                               cut.y_traj[:4], v_des))
    check_rows(r, cfg_a)
    expect(got, loop_launches(cfg_a.with_risk_mode("cvar")),
           "Path E d, one chunk of 4")
    per_solve["path_e_cvar4"] = dict(got)
    path_launches.append(got)
    log(f"Path E d, Path B cvar at scenario_chunk 4: {4 / secs:.2f} solves/s "
        f"({1e3 * secs:.1f} ms a chunk); launches {got}")

    # e. the sweep CLI with --dispatch batch against Path C's pipeline sweep
    flags = list(SWEEP_FLAGS)
    flags[flags.index("--chunk") + 1] = "8"
    flags[flags.index("--dispatch") + 1] = "batch"
    n_cfg = int(flags[flags.index("--num_configs") + 1])
    n_chunks = sum(-(-min(8, n_cfg - lo) // 4) for lo in range(0, n_cfg, 8))
    data_b = os.path.join(work, "data_batch")
    _, secs_b, got = counted(
        torch, ops, "Path E batch sweep", (KC, K4, D),
        lambda: sweep_cli.main(["--costs", "mmd_opt", "--out", data_b, *flags,
                                "--scenario_chunk", "4"]))
    want = {k: n_chunks * v for k, v in one_solve.items()}
    draws = ops.prng_draws.__name__
    want[draws] += loop_launches(cfg, 0, fresh=True)[draws]   # its solver's
    expect(got, want, f"Path E e, {n_chunks} chunks of 4 scenarios")
    per_solve["sweep_batch_mmd_opt"] = {k: v / n_chunks for k, v in got.items()}
    path_launches.append(got)
    root_p, secs_p = sweeps["mmd_opt"]
    found = glob.glob(os.path.join(data_b, "static", "*", "*", "*", "mmd_opt_*"))
    if len(found) != 1:
        fail(f"Path E e: expected one store, found {found}")
    pipe, bat = ResultStore(root_p).concatenated(), ResultStore(found[0]).concatenated()
    same = np.array_equal(pipe["seeds"], bat["seeds"])
    gap = max((float(np.abs(bat[f] - pipe[f]).max()) / max(1.0, float(np.abs(pipe[f]).max()))
               if same and len(pipe[f]) else 0.0) for f in ("cx", "cy"))
    log(f"Path E e, the sweep CLI over Path C's {n_cfg} static scenarios in mmd_opt: "
        f"--dispatch pipeline {n_cfg / secs_p:.2f} solves/s, --dispatch batch --chunk 8 "
        f"--scenario_chunk 4 {n_cfg / secs_b:.2f} solves/s; accepted {len(pipe['seeds'])} "
        f"and {len(bat['seeds'])}, the same seeds: {same}; cx, cy max gap over "
        f"their scale {gap:.3e}; launches {got}")
    if not same or gap > 1e-4:
        fail("Path E e: the batch dispatch stored other seeds or coefficients than "
             "the pipeline")

    # f. one exact solve of fastrt and of the on-road stack, no host sync
    cfg_x = cfg.replace(solve_strategy="exact")
    sx = Solver(cfg_x, device=dev)
    check_solve(sx.solve(0, init, mean, cov, xs[0], ys[0], 15.0), cfg_x)   # warm-up
    r, secs, got = counted(torch, ops, "Path E exact", (ops.fused_rollout, D),
                           lambda: without_sync(
        torch, lambda: sx.solve(1, init, mean, cov, xs[1], ys[1], 15.0)))
    check_solve(r, cfg_x)
    expect(got, loop_launches(cfg_x),
           "Path E f, fastrt exact")
    per_solve["path_e_exact"] = dict(got)
    path_launches.append(got)
    log(f"Path E f, fastrt mmd_opt exact: {1e3 * secs:.1f} ms a solve under the sync "
        f"debug mode, no host sync; risk_obs {float(r.risk_obs):.4f}; launches {got}")
    cfg_dx = cfg_d.replace(solve_strategy="exact")
    init_o, mean_o, cov_o, *rest = onroad_problem(torch, cfg_dx, dev)
    args = (init_o, f32(mean_o), f32(cov_o), *rest)
    fx = FrenetSolver(cfg_dx, device=dev)
    check_frenet_solve(fx.solve(0, *args), cfg_dx, "Path E exact on-road warm-up")
    r, secs, got = counted(torch, ops, "Path E exact on-road", (ops.fused_rollout, D),
                           lambda: without_sync(torch, lambda: fx.solve(1, *args)))
    check_frenet_solve(r, cfg_dx, "Path E exact on-road")
    expect(got, loop_launches(cfg_dx, frenet=True), "Path E f, on-road exact")
    per_solve["path_d_exact"] = dict(got)
    path_launches.append(got)
    log(f"Path E f, Path D mmd_opt exact FrenetSolver: {1e3 * secs:.1f} ms a solve "
        f"under the sync debug mode, no host sync; risk_obs {float(r.risk_obs):.4f}; "
        f"launches {got}")

    # g. one outer iteration of fastrt exact, card against CPU
    xo, yo = obstacle_scenarios(torch, 1, cfg.obstacles.num_obs,
                                sx.ws.tot_time.cpu(), blocking=True)[0]
    cuda_vs_cpu(torch, cfg_x.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=1)),
                (INIT, MEAN, COV, xo, yo, 15.0), "Path E exact")
    return path_launches


def path_selections(torch, ops, dev, cfg, cfg_a, cfg_d, per_solve):
    """Phase 12: the "xt" and "g" selections (``MPC_MMD_SELECTION``) on the
    fastrt, Path A and Path D solves, and the fastrt solve without
    elite-carry (``MPC_MMD_ELITE_CARRY=0``; see the module docstring).
    Returns the launch counts of its runs; adds each run's launches per
    solve to ``per_solve``."""
    from mpc_mmd_tpu_torch import FrenetSolver, Solver
    from mpc_mmd_tpu_torch.scenarios import dynamic_cutin, ego_initial_state

    K4 = ops.noisy_rollout
    names = [fn.__name__ for fn in ops.KERNELS]
    init_d, mean_d, cov_d, v_des = ego_initial_state("dynamic")
    cut = dynamic_cutin(cfg_a, 2, device=dev)
    onroad = onroad_problem(torch, cfg_d, dev)
    fastrt = Solver(cfg, device=dev)
    scen = obstacle_scenarios(torch, 2, cfg.obstacles.num_obs, fastrt.ws.tot_time)
    frenet_check = lambda r, c: check_frenet_solve(r, c, "Path D")
    paths = {
        "fastrt": (cfg, fastrt, check_solve,
                   [(i, (INIT, MEAN, COV, *scen[i], 15.0)) for i in (0, 1)]),
        "path_a": (cfg_a, Solver(cfg_a, device=dev), check_solve,
                   [(i, (init_d, mean_d, cov_d, cut.x_traj[i], cut.y_traj[i], v_des))
                    for i in (0, 1)]),
        "path_d": (cfg_d, FrenetSolver(cfg_d, device=dev), frenet_check,
                   [(i, onroad) for i in (0, 1)])}
    xo, yo = obstacle_scenarios(torch, 1, cfg.obstacles.num_obs,
                                fastrt.ws.tot_time.cpu(), blocking=True)[0]
    one_iter = lambda c: c.replace(cem=dataclasses.replace(c.cem, maxiter_cem=1))
    path_launches = []
    # fastrt "xla" without elite-carry: its chain's bits from kernel (c)
    os.environ["MPC_MMD_ELITE_CARRY"] = "0"
    try:
        check_solve(fastrt.solve(0, INIT, MEAN, COV, *scen[0], 15.0), cfg)  # warm-up
        inner = inner_launches(cfg, "xla", carry=False)
        r, secs, got = counted(torch, ops, "fastrt xla, no elite-carry",
                               kernels_of(ops, inner) + (K4, ops.prng_plan),
                               lambda: fastrt.solve(1, INIT, MEAN, COV, *scen[1], 15.0))
        check_solve(r, cfg)
        want = {k: {**inner, **loop_launches(cfg)}.get(k, 0) for k in names}
        if got != want:
            fail(f"fastrt without elite-carry: launches {got}, expected {want}")
        per_solve["fastrt_nocarry"] = dict(got)
        path_launches.append(got)
        log(f"fastrt mmd_opt, 'xla' without elite-carry: {1e3 * secs:.1f} ms a solve, "
            f"risk_obs {float(r.risk_obs):.4f}; launches {got}")
        cuda_vs_cpu(torch, one_iter(cfg), (INIT, MEAN, COV, xo, yo, 15.0),
                    "fastrt xla, no elite-carry")
    finally:
        os.environ.pop("MPC_MMD_ELITE_CARRY")
    for sel in ("xt", "g"):
        os.environ["MPC_MMD_SELECTION"] = sel
        try:
            for name, (c, solver, check, calls) in paths.items():
                check(solver.solve(calls[0][0], *calls[0][1]), c)       # warm-up
                inner = inner_launches(c, sel)
                r, secs, got = counted(torch, ops, f"{name} {sel}",
                                       kernels_of(ops, inner) + (K4, ops.prng_plan),
                                       lambda: solver.solve(calls[1][0], *calls[1][1]))
                check(r, c)
                want = {**inner, **loop_launches(c, frenet=name == "path_d")}
                want = {k: want.get(k, 0) for k in names}
                if got != want:
                    fail(f"{name} with the {sel!r} selection: launches {got}, "
                         f"expected {want}")
                per_solve[f"{name}_{sel}"] = dict(got)
                path_launches.append(got)
                log(f"{name} mmd_opt, {sel!r} selection: {1e3 * secs:.1f} ms a solve, "
                    f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.0f} MiB, "
                    f"risk_obs {float(r.risk_obs):.4f}; launches {got}")
            cuda_vs_cpu(torch, one_iter(cfg), (INIT, MEAN, COV, xo, yo, 15.0),
                        f"fastrt {sel}")
            cuda_vs_cpu(torch, one_iter(cfg_a), (init_d, mean_d, cov_d,
                                                 cut.x_traj[0].cpu(),
                                                 cut.y_traj[0].cpu(), v_des),
                        f"Path A {sel}")
            err = frenet_cuda_vs_cpu(torch, cfg_d, dev, onroad, 1)
            log(f"Path D {sel} cuda vs cpu, one outer iteration on seed 1's draws: "
                f"v_best and steering_best max diff {err:.3e}")
            if not err <= 1e-3:
                fail(f"Path D {sel}: the controls differ between cuda and cpu by "
                     f"{err} (> 1e-3)")
        finally:
            os.environ.pop("MPC_MMD_SELECTION")
    return path_launches


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def scaled_gap(a, b):
    """Largest difference of a and b over the larger of 1 and b's scale."""
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


def rank_main(spec_json):
    """One rank of phase 13's two-rank group (``chip_smoke.py --rank SPEC``
    under ``torch.distributed.run``): the sweep CLI with ``--dispatch
    mesh``, ``validate --mesh`` on its store, and a candidate-split fastrt
    solve against the plain one; writes ``rank{r}.json`` with each part's
    seconds and launch counts into the spec's ``records`` directory."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, HERE)
    from mpc_mmd_tpu_torch import Solver, fastrt_workload, ops
    from mpc_mmd_tpu_torch.cli import sweep as sweep_cli
    from mpc_mmd_tpu_torch.cli import validate as validate_cli
    from mpc_mmd_tpu_torch.parallel import initialize_distributed, make_mesh

    spec = json.loads(spec_json)
    rank = initialize_distributed()
    out = {"rank": rank, "backend": dist.get_backend(),
           "world": dist.get_world_size()}

    def part(name, fn):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t0,
                     "launches": {f.__name__: f.launches for f in ops.KERNELS}}
        return r

    part("sweep", lambda: sweep_cli.main(spec["sweep"]))
    root = glob.glob(os.path.join(spec["data"], "static", "*", "*", "*", "mmd_opt_*"))[0]
    part("validate", lambda: validate_cli.main(["--data", root, "--mesh", "--n_mc",
                                                "1000", "--out", spec["stats"]]))
    cfg = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50, mode="mmd_opt",
                          noise="gaussian", noise_level=0.1)
    split = Solver(cfg, candidate_mesh=make_mesh())
    xo, yo = obstacle_scenarios(torch, 1, cfg.obstacles.num_obs, split.ws.tot_time,
                                blocking=True)[0]
    args = (INIT, MEAN, COV, xo, yo, 15.0)
    split.solve(0, *args)                                               # warm-up
    r = part("split", lambda: split.solve(1, *args))
    ref = Solver(cfg, ws=split.ws).solve(1, *args)
    out["split_gap"] = {f: scaled_gap(getattr(r, f), getattr(ref, f))
                        for f in ("res", "cx", "cy", "risk_obs")}
    out["split_finite"] = bool(r.cx.isfinite().all())
    with open(os.path.join(spec["records"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def path_dist(torch, ops, dev, cfg, work, per_solve):
    """Phase 13: the distribution layer (see the module docstring).
    Returns the launch counts of its runs (the two ranks' summed); adds
    launches per solve to ``per_solve``."""
    import signal
    import torch.distributed as dist
    from mpc_mmd_tpu_torch import Solver
    from mpc_mmd_tpu_torch.cli import prewarm as prewarm_cli
    from mpc_mmd_tpu_torch.cli import validate as validate_cli
    from mpc_mmd_tpu_torch.parallel import (initialize_distributed, make_mesh,
                                            sharded_sweep)
    from mpc_mmd_tpu_torch.utils.debug import hosts_alive
    from mpc_mmd_tpu_torch.utils.io_store import ResultStore

    KC, K4 = ops.inner_cem, ops.noisy_rollout
    names = [fn.__name__ for fn in ops.KERNELS]
    one_solve = {k: round(per_solve["fastrt"].get(k, 0)) for k in names}
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    path_launches = []

    def expect(got, n, label, fresh=0, split=False):
        """n solves' launches, and the solver-fixed draws of ``fresh``
        solvers' first solves; with the candidates ``split`` over the ranks
        no kernel (e) (each rank scores its own block) and the chains around
        the rollouts (K4 on each rank's block)."""
        want = {k: n * v for k, v in one_solve.items()}
        want[ops.prng_draws.__name__] += fresh * loop_launches(
            cfg, 0, fresh=True)[ops.prng_draws.__name__]
        if split:
            chain = loop_launches(cfg, n, split=True)
            for k in ("outer_tail", "fused_rollout", "noisy_rollout", "inner_prologue"):
                want[k] = chain[k]
        if got != want:
            fail(f"{label}: launches {got}, expected {want} ({n} solves' worth)")

    # a. a one-rank NCCL group: sharded_sweep over 8 fastrt scenarios
    initialize_distributed(f"localhost:{free_port()}", 1, 0)
    try:
        backend = dist.get_backend()
        if backend != "nccl":
            fail(f"a one-rank group on one card took {backend!r}, not NCCL")
        solver = Solver(cfg, device=dev)
        xs, ys = stacked(torch, obstacle_scenarios(torch, 8, cfg.obstacles.num_obs,
                                                   solver.ws.tot_time))
        seeds, init, mean, cov = list(range(1, 9)), f32(INIT), f32(MEAN), f32(COV)
        sweep = sharded_sweep(cfg, solver.ws, make_mesh(1))
        r, secs, got = counted(torch, ops, "distribution a", (KC, K4, ops.prng_plan),
                               lambda: sweep(seeds, init, mean, cov, xs, ys, 15.0))
        expect(got, 8, "distribution a, sharded_sweep of 8 scenarios", fresh=1)
        per_solve["dist_nccl"] = {k: v / 8 for k, v in got.items()}
        path_launches.append(got)
        ref = solver.solve_batch(seeds, init, mean, cov, xs, ys, 15.0)
        gaps = {f: float((getattr(r, f) - getattr(ref, f)).abs().max())
                for f in r._fields}
        alive = hosts_alive(60.0)
        log(f"distribution a, a one-rank {backend} group: sharded_sweep over 8 fastrt "
            f"scenarios {8 / secs:.2f} solves/s; against solve_batch, largest "
            f"difference per field {gaps}; hosts_alive (an NCCL all_reduce): {alive}")
        if any(gaps.values()) or not alive:
            fail("distribution a: the sharded sweep is not solve_batch bit for bit, "
                 "or the heartbeat failed")
    finally:
        dist.destroy_process_group()

    # b-d. two gloo ranks on the one card (NCCL refuses two ranks on one
    # device): the mesh sweep over Path C's 40 scenarios, validate --mesh,
    # and the candidate split
    flags = list(SWEEP_FLAGS)
    flags[flags.index("--chunk") + 1] = "8"
    flags[flags.index("--dispatch") + 1] = "mesh"
    data_m, stats_m = os.path.join(work, "data_mesh"), os.path.join(work, "stats_mesh")
    spec = {"data": data_m, "stats": stats_m, "records": work,
            "sweep": ["--costs", "mmd_opt", "--out", data_m, *flags,
                      "--scenario_chunk", "4", "--heartbeat_every", "1"]}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", os.path.join(HERE, "chip_smoke.py"), "--rank",
           json.dumps(spec)]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        so, se = proc.communicate(timeout=400)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        fail("distribution b-d: the two ranks did not finish within 400 s")
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"distribution b-d: torch.distributed.run exited {proc.returncode}:\n"
             f"{se[-4000:]}")
    ranks = []
    for r in range(2):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if [o["rank"] for o in ranks] != [0, 1] or {o["backend"] for o in ranks} != {"gloo"}:
        fail(f"distribution b-d: rank records {ranks}")
    summed = {p: {k: sum(o[p]["launches"][k] for o in ranks) for k in names}
              for p in ("sweep", "validate", "split")}
    path_launches += list(summed.values())

    # b. the merged store against Path E e's batch store, bit for bit
    n_cfg = int(flags[flags.index("--num_configs") + 1])
    n_chunks = sum(-(-min(8, n_cfg - lo) // 4) for lo in range(0, n_cfg, 8))
    expect(summed["sweep"], n_chunks, f"distribution b, {n_chunks} chunks of 4 "
           "scenarios over 2 ranks", fresh=2)
    per_solve["dist_mesh_sweep"] = {k: v / n_chunks for k, v in summed["sweep"].items()}
    found = [glob.glob(os.path.join(work, d, "static", "*", "*", "*", "mmd_opt_*"))
             for d in ("data_mesh", "data_batch")]
    if any(len(f) != 1 for f in found):
        fail(f"distribution b: expected one store each, found {found}")
    mesh_store = ResultStore(found[0][0])
    mesh_arrays, batch_arrays = (mesh_store.concatenated(),
                                 ResultStore(found[1][0]).concatenated())
    files = os.listdir(found[0][0])
    same = (set(mesh_arrays) == set(batch_arrays)
            and all(np.array_equal(mesh_arrays[k], batch_arrays[k]) for k in batch_arrays))
    sweep_s = max(o["sweep"]["s"] for o in ranks)
    log(f"distribution b, torch.distributed.run --nproc_per_node 2 (gloo, one card) "
        f"of the sweep CLI --dispatch mesh --chunk 8 --scenario_chunk 4 "
        f"--heartbeat_every 1 over {n_cfg} static scenarios: {n_cfg / sweep_s:.2f} "
        f"solves/s in the sweep ({sweep_s:.1f} s; {wall:.1f} s with the ranks' "
        f"start-up and the other parts), chunks {mesh_store.done_chunks()}, shard "
        f"manifests {sorted(f for f in files if f.startswith('manifest'))}; the merged "
        f"store equals Path E e's batch store bit for bit: {same}; launches {summed['sweep']}")
    if mesh_store.done_chunks() != list(range(-(-n_cfg // 8))) or not same \
            or "manifest_p001.json" not in files:
        fail("distribution b: the mesh sweep's merged store is not the batch store")

    # c. validate --mesh against the same validation in one process
    single = validate_cli.validate_store(found[0][0], n_mc=1000, device=dev,
                                         out_root=os.path.join(work, "stats_single"))
    with np.load(os.path.join(stats_m, "validation.npz")) as z:
        equal = all(np.array_equal(z[k], single[k])
                    for k in ("coll_count", "lane_count", "coll_fraction"))
    per_solve["dist_validate"] = dict(summed["validate"])
    log(f"distribution c, validate --mesh on 2 ranks, n_mc 1000, "
        f"{single['n_solves']} solves: {max(o['validate']['s'] for o in ranks):.2f} s; "
        f"counts equal to the single run's: {equal}; launches {summed['validate']}")
    if not equal or not summed["validate"]["fused_rollout"]:
        fail("distribution c: validate --mesh differs from the single validation")

    # d. the candidate split of one fastrt solve over the 2 ranks
    gaps = [o["split_gap"] for o in ranks]
    # each rank runs every stage of the solve on its half of the candidates
    # (kernel (d) on all of them, the tail as its chain)
    expect(summed["split"], 2, "distribution d, one solve's candidates over 2 ranks",
           split=True)
    per_solve["dist_split"] = dict(summed["split"])
    log(f"distribution d, one fastrt solve's 64 candidates over 2 gloo ranks: "
        f"{1e3 * max(o['split']['s'] for o in ranks):.1f} ms; against the plain "
        f"solve, largest gap over the scale per rank {gaps}; launches (both ranks) "
        f"{summed['split']}")
    if not all(o["split_finite"] for o in ranks) or any(
            g["res"] > 1e-5 or max(g["cx"], g["cy"]) > 1e-4 for g in gaps):
        fail("distribution d: the candidate split is off the plain solve "
             "(res 1e-5, cx and cy 1e-4 of their scale)")

    # e. prewarm: the build (found), then one solve per (preset, mode)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, secs, got = counted(torch, ops, "prewarm", (KC, K4), lambda: prewarm_cli.main(
            ["--presets", "fastrt", "--modes", "mmd_opt", "cvar"]))
    lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.strip()]
    if [(l.get("preset"), l.get("mode")) for l in lines[:-1]] != [
            ("fastrt", "mmd_opt"), ("fastrt", "cvar")] or lines[-1].get("prewarmed") != 2:
        fail(f"prewarm printed {lines}")
    path_launches.append(got)
    log(f"distribution e, python -m mpc_mmd_tpu_torch.cli.prewarm --presets fastrt "
        f"--modes mmd_opt cvar: {secs:.2f} s; {lines}; launches {got}")
    return path_launches


def graph_against_eager(torch, ops, label, make, calls, kernels):
    """Phase 16a: each of ``calls`` (a function of a solver) on a graphed
    solver, ``make(None)``, and on an eager one, ``make(False)``, in turn:
    the results bit for bit equal and each call's launch counts equal (and
    every kernel of ``kernels`` launched); every call after the first (a
    replay) under CUDA's sync debug mode at "error"; every result kept
    unchanged to the end.  Returns the graphed and the eager solver and
    the counts of both runs."""
    graphed, eager = make(None), make(False)
    if not graphed.graph or eager.graph:
        fail(f"16a {label}: graph={graphed.graph} by default, {eager.graph} with "
             f"graph=False")
    kept, total = [], {fn.__name__: 0 for fn in ops.KERNELS}
    for i, call in enumerate(calls):
        outs, counts = [], []
        for solver in (graphed, eager):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            if solver is graphed and i:
                torch.cuda.set_sync_debug_mode("error")
            try:
                outs.append(call(solver))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            counts.append(ops.launch_counts())
            total = {k: n + counts[-1][k] for k, n in total.items()}
        missing = [fn.__name__ for fn in kernels if counts[0][fn.__name__] < 1]
        if counts[0] != counts[1] or missing:
            fail(f"16a {label}, call {i}: launches graphed {counts[0]}, eager "
                 f"{counts[1]}; not launched {missing}")
        apart = [f for f, a, b in zip(outs[0]._fields, *outs) if not torch.equal(a, b)]
        if apart:
            fail(f"16a {label}, call {i}: the graphed solve differs from the eager one "
                 f"in {apart}")
        kept.append((outs[0], [t.clone() for t in outs[0]]))
    if not all(torch.equal(a, b) for got, copy in kept for a, b in zip(got, copy)):
        fail(f"16a {label}: a later solve changed a result kept from an earlier one")
    stats = graphed.graph_stats()
    log(f"16a {label}: {len(calls)} solves (the first captures), graphed bit-equal "
        f"to eager with equal launches, the replays with no host sync, the earlier "
        f"results unchanged; graphs " + "; ".join(
            f"{s['nodes']} nodes, capture {s['capture_s']:.3f} s, instantiate "
            f"{s['instantiate_s']:.3f} s, {s['replays']} replays" for s in stats))
    return graphed, eager, total


def in_turns(torch, runs, n):
    """The callables ``runs`` {label: fn} in turns, ``n`` calls each (a b,
    b a, a b, ...): each call's host seconds to ``torch.cuda.synchronize``,
    by label."""
    times = {label: [] for label in runs}
    for i in range(n):
        for label in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            t0 = time.perf_counter()
            runs[label]()
            torch.cuda.synchronize()
            times[label].append(time.perf_counter() - t0)
    return times


def percentiles(secs):
    """p50 and p99 milliseconds, unrounded."""
    p50, p99 = np.percentile(1e3 * np.asarray(secs), [50, 99])
    return float(p50), float(p99)


def path_graph(torch, ops, dev, cfg, cfg_a, cfg_d, per_solve):
    """Phase 16: the solve as one CUDA graph (see the module docstring).
    Returns the launch counts of its runs and its record."""
    from mpc_mmd_tpu_torch import FrenetSolver, Solver
    from mpc_mmd_tpu_torch.closedloop import (SyntheticPlant, local_problem,
                                              make_route, run_episode)
    from mpc_mmd_tpu_torch.frenet import build_smoother
    from mpc_mmd_tpu_torch.scenarios import dynamic_cutin, ego_initial_state

    t_phase = time.perf_counter()
    K4, KC, D, B = ops.noisy_rollout, ops.inner_cem, ops.prng_plan, ops.prng_beta
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    path_launches, record = [], {}

    # a. graphed against eager, bit for bit
    tot = torch.as_tensor(np.linspace(0, cfg.horizon.t_fin, cfg.horizon.num),
                          dtype=torch.float32, device=dev)
    xs, ys = stacked(torch, obstacle_scenarios(torch, 8, cfg.obstacles.num_obs, tot))
    fastrt_calls = [lambda s, i=i: s.solve(
        300 + i, [0.0, 1.75 - 0.1 * i, 5.0 + i, 0.0, 0.0, 0.0], MEAN, COV, xs[i], ys[i],
        15.0 - i) for i in range(3)]
    g_fastrt, e_fastrt, got = graph_against_eager(
        torch, ops, "fastrt", lambda graph: Solver(cfg, device=dev, graph=graph),
        fastrt_calls, (KC, K4, D))
    path_launches.append(got)
    init, mean, cov = f32(INIT), f32(MEAN), f32(COV)
    chunk_calls = [lambda s, lo=lo: s.solve_batch(list(range(lo, lo + 7)), init, mean,
                                                  cov, xs[:7], ys[:7], 15.0)
                   for lo in (400, 420)]
    _, _, got = graph_against_eager(
        torch, ops, "fastrt solve_batch of 7 at chunk 4",
        lambda graph: Solver(cfg, device=dev, scenario_chunk=4, graph=graph),
        chunk_calls, (KC, K4, D))
    path_launches.append(got)
    init_d, mean_d, cov_d, v_des = ego_initial_state("dynamic")
    cut = dynamic_cutin(cfg_a, 3, device=dev)
    os.environ["MPC_MMD_FUSED_CEM"] = "1"
    try:
        a_calls = [lambda s, i=i: s.solve(500 + i, init_d, mean_d, cov_d, cut.x_traj[i],
                                          cut.y_traj[i], v_des) for i in range(3)]
        g_a, e_a, got = graph_against_eager(
            torch, ops, "Path A fused, Beta noise",
            lambda graph: Solver(cfg_a, device=dev, graph=graph), a_calls,
            kernels_of(ops, inner_launches(cfg_a, "fused")) + (K4, D, B))
    finally:
        os.environ.pop("MPC_MMD_FUSED_CEM")
    path_launches.append(got)
    os.environ["MPC_MMD_SELECTION"] = "xt"
    try:
        _, _, got = graph_against_eager(
            torch, ops, "fastrt xt", lambda graph: Solver(cfg, device=dev, graph=graph),
            fastrt_calls, kernels_of(ops, inner_launches(cfg, "xt")) + (K4, D))
    finally:
        os.environ.pop("MPC_MMD_SELECTION")
    path_launches.append(got)
    g_ax, e_ax, got = graph_against_eager(
        torch, ops, "Path A xla, Beta noise",
        lambda graph: Solver(cfg_a, device=dev, graph=graph), a_calls[:2],
        (KC, K4, D, B))
    path_launches.append(got)
    # Path B cvar and Path D det: their tails and det's projection on (d), (e)
    KD, KE = ops.outer_project, ops.outer_tail
    _, _, got = graph_against_eager(
        torch, ops, "Path B cvar, Beta noise",
        lambda graph: Solver(cfg_a.with_risk_mode("cvar"), device=dev, graph=graph),
        a_calls[:2], (KD, KE, K4, D, B))
    path_launches.append(got)
    plant = SyntheticPlant(cfg_d, make_route("curved"), ONROAD_OBSTACLES,
                           obstacle_speed=1.0)
    smoother = build_smoother(cfg_d.frenet.num_path, device=dev)
    steps = []
    tot_d = torch.as_tensor(np.linspace(0, cfg_d.horizon.t_fin, cfg_d.horizon.num),
                            dtype=torch.float32, device=dev)
    for k in range(3):
        frame, xo, yo, init_g = local_problem(cfg_d, plant, smoother, tot_d)
        steps.append((600 + k, init_g, [10.0 + k] * 4 + [0.3 * k] * 4, COV, xo, yo,
                      10.0 + 2 * k, frame))
        plant.step(1.0, 0.02)
    g_d, e_d, got = graph_against_eager(
        torch, ops, "Path D FrenetSolver mmd_opt, 3 steps, every input changed",
        lambda graph: FrenetSolver(cfg_d, device=dev, graph=graph),
        [lambda s, a=a: s.solve(*a) for a in steps], (KC, K4, ops.frenet_states, D))
    path_launches.append(got)
    g_det, _, got = graph_against_eager(
        torch, ops, "Path D FrenetSolver det, 3 steps, every input changed",
        lambda graph: FrenetSolver(cfg_d.with_risk_mode("det"), device=dev, graph=graph),
        [lambda s, a=a: s.solve(*a) for a in steps], (KD, KE, ops.frenet_states, D))
    path_launches.append(got)

    # b. eager against graphed, in turns
    ops.reset_launch_counts()
    lat = in_turns(torch, {"eager": lambda: e_fastrt.solve(
        7, INIT, MEAN, COV, xs[7], ys[7], 15.0), "graphed": lambda: g_fastrt.solve(
        7, INIT, MEAN, COV, xs[7], ys[7], 15.0)}, 20)
    record["fastrt_ms"] = {k: percentiles(v) for k, v in lat.items()}
    rates = {}
    for n in (4, 8):
        solvers = {k: Solver(cfg, device=dev, scenario_chunk=n, graph=g)
                   for k, g in (("eager", False), ("graphed", None))}
        runs = {k: (lambda s=s: s.solve_batch(list(range(700, 708)), init, mean, cov,
                                             xs, ys, 15.0)) for k, s in solvers.items()}
        for fn in runs.values():
            fn()                                     # the graph's capture
        secs = in_turns(torch, runs, 4)
        rates[n] = {k: 8 / float(np.median(v)) for k, v in secs.items()}
    record["chunk_solves_per_s"] = rates
    os.environ["MPC_MMD_FUSED_CEM"] = "1"
    try:
        lat_a = in_turns(torch, {k: (lambda s=s: s.solve(
            9, init_d, mean_d, cov_d, cut.x_traj[0], cut.y_traj[0], v_des))
            for k, s in (("eager", e_a), ("graphed", g_a))}, 6)
    finally:
        os.environ.pop("MPC_MMD_FUSED_CEM")
    record["path_a_fused_ms"] = {k: percentiles(v) for k, v in lat_a.items()}
    lat_ax = in_turns(torch, {k: (lambda s=s: s.solve(
        9, init_d, mean_d, cov_d, cut.x_traj[0], cut.y_traj[0], v_des))
        for k, s in (("eager", e_ax), ("graphed", g_ax))}, 6)
    record["path_a_xla_ms"] = {k: percentiles(v) for k, v in lat_ax.items()}
    episodes = {"eager": [], "graphed": []}
    for label in ("eager", "graphed", "graphed", "eager"):
        solver = e_d if label == "eager" else g_d
        r = run_episode(cfg_d, route_kind="curved", v_des=15.0, max_steps=20,
                        goal_arc=300.0, seed=0, solver=solver)
        episodes[label] += r.solve_times
    record["closed_loop_step_ms"] = {k: percentiles(v) for k, v in episodes.items()}
    record["closed_loop_step_mean_ms"] = {k: 1e3 * float(np.mean(v))
                                          for k, v in episodes.items()}
    got = ops.launch_counts()
    missing = [fn.__name__ for fn in (*kernels_of(ops, inner_launches(cfg_a, "fused")),
                                      K4, KC, D, B) if got[fn.__name__] < 1]
    if missing:
        fail(f"16b: kernels of the timed paths not launched: {missing}")
    path_launches.append(got)
    log(f"16b: eager against graphed in turns, host ms to synchronize (p50, p99): "
        f"fastrt {record['fastrt_ms']} (20 each); Path A fused "
        f"{record['path_a_fused_ms']} (6 each); Path A xla {record['path_a_xla_ms']} "
        f"(6 each); solve_batch over 8 scenarios, solves/s "
        f"(median of 4): {rates}; the Path D closed-loop step (2 episodes of 20 steps "
        f"each) {record['closed_loop_step_ms']}, mean "
        f"{record['closed_loop_step_mean_ms']}, against the 150 ms period: graphed p99 "
        f"{'meets' if record['closed_loop_step_ms']['graphed'][1] <= 150 else 'misses'} it")

    # c. graphed solves (replays) under torch.profiler, and the busy time
    # against the p50 of 5 untraced replays of the same solve
    traces = {}
    for label, solver, fn in (
            ("fastrt", g_fastrt, lambda: g_fastrt.solve(8, INIT, MEAN, COV, xs[0], ys[0],
                                                        15.0)),
            ("path_a_fused", g_a, lambda: g_a.solve(10, init_d, mean_d, cov_d,
                                                    cut.x_traj[1], cut.y_traj[1], v_des)),
            ("path_a_xla", g_ax, lambda: g_ax.solve(10, init_d, mean_d, cov_d,
                                                    cut.x_traj[1], cut.y_traj[1], v_des)),
            ("path_d", g_d, lambda: g_d.solve(*steps[0]))):
        fused = label == "path_a_fused"
        if fused:
            os.environ["MPC_MMD_FUSED_CEM"] = "1"
        try:
            before = [g["replays"] for g in solver.graph_stats()]
            p50 = percentiles(in_turns(torch, {label: fn}, 5)[label])[0]
            _, summary, _ = traced(fn)
            after = [g["replays"] for g in solver.graph_stats()]
        finally:
            if fused:
                os.environ.pop("MPC_MMD_FUSED_CEM")
        if len(after) != len(before) or sum(after) != sum(before) + 6:
            fail(f"16c {label}: the timed and traced solves were not all replays "
                 f"({before} -> {after})")
        traces[label] = {k: summary[k] for k in ("wall_ms", "device_busy_ms",
                                                 "idle_share", "device_events")}
        traces[label].update(untraced_p50_ms=p50,
                             idle_share_of_untraced=1.0 - summary["device_busy_ms"] / p50)
    record["traced"] = traces
    log(f"16c: one graphed solve each (a replay) under torch.profiler: {traces}")

    # d. every graph of this phase
    record["graphs"] = {label: [{k: s[k] for k in ("nodes", "capture_s", "instantiate_s",
                                                   "replays")} for s in g.graph_stats()]
                        for label, g in (("fastrt", g_fastrt), ("path_a_fused", g_a),
                                         ("path_a_xla", g_ax), ("path_d", g_d),
                                         ("path_d_det", g_det))}
    log(f"16d: graph nodes, Path D mmd_opt "
        f"{[g['nodes'] for g in record['graphs']['path_d']]}, det "
        f"{[g['nodes'] for g in record['graphs']['path_d_det']]}")
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")
    return path_launches, record


RECORD_SIZES = (5, 15)         # the JAX record's N = 5 and N = 15 cells
SELECTIONS_F = ("xla", "fused", "xt")


def record_config(N):
    """The static workload of the JAX record's acceptance grid at N
    (artifacts/acceptance/run_static_r3.sh): Beta noise 0.3, 6 obstacles,
    ts 50, the reference budget (100 x 20 outer and inner)."""
    from mpc_mmd_tpu_torch import static_workload
    return static_workload(num_reduced=N, num_obs=6, num_prime=50, noise="beta",
                           noise_level=0.3, mode="mmd_opt")


def path_sizes(torch, ops, dev, work, per_solve, tables):
    """Phase 14: every reduced-set size N = 2 ... 16 (see the module
    docstring).  ``tables`` maps each kernel's name to {shape: {path:
    launches per solve}} (``launch_shapes`` and phase 3's K3 and K4
    shapes).  Returns the launch counts of its runs; adds Path F's
    launches per solve to ``per_solve``."""
    from mpc_mmd_tpu_torch import Solver
    from mpc_mmd_tpu_torch.cli import sweep as sweep_cli
    from mpc_mmd_tpu_torch.cli import validate as validate_cli
    from mpc_mmd_tpu_torch.linalg import eq_qp_solve as qp_plain
    from mpc_mmd_tpu_torch.ops.topk import topk_indices_plain, topk_onehot_plain
    from mpc_mmd_tpu_torch.ops.topk_kernel import topk_kernel_matrices_plain
    from mpc_mmd_tpu_torch.utils.io_store import ResultStore
    from mpc_mmd_tpu_torch.utils.kernel_ab import k1_inputs, k2_inputs, k3_inputs

    t_phase = time.perf_counter()
    names = [fn.__name__ for fn in ops.KERNELS]
    path_launches = []

    # a. K1, K5, K2, K2t and K3 against their twins at every N
    gen = torch.Generator(device=dev).manual_seed(14)
    err = 0.0
    for N in range(2, 17):
        M = N * N
        kw = dict(absolute=True, slice_to=M)
        for shape in ((100, 89, M + 1), (1, 100, M + 1)):
            x = k1_inputs(gen, shape, N, True)
            if not torch.equal(ops.topk_indices(x, N, **kw),
                               topk_indices_plain(x, N, **kw)):
                fail(f"14a: K1 differs from its twin at {shape}, k={N}")
        x = k1_inputs(gen, (100, 89, M + 1), N, True)
        if not all(torch.equal(a, b) for a, b in zip(ops.topk_onehot(x, N, **kw),
                                                     topk_onehot_plain(x, N, **kw))):
            fail(f"14a: K5 differs from its twin at (100, 89, {M + 1}), k={N}")
        for count in (8900, 10000):
            C, r = k2_inputs(gen, count, N)
            b, mu = ops.eq_qp_solve(C, r)
            b64, mu64 = qp_plain(C.double(), r.double())
            for name, got, ref in (("b", b, b64), ("mu", mu, mu64)):
                bad = (got.double() - ref).abs() > 1e-4 * ref.abs() + 1e-5
                if bool(bad.any()) or not bool(torch.isfinite(got).all()):
                    fail(f"14a: K2 {name} outside rtol 1e-4 + atol 1e-5 of the float64 "
                         f"twin at {int(bad.sum())} entries ({count} systems, n={N})")
            err = max(err, float((b.double() - b64).abs().max()))
            b_t, mu_t = ops.eq_qp_solve_t(C.reshape(count, N * N).T.contiguous(),
                                          r.T.contiguous())
            if not (torch.equal(b_t, b.T) and torch.equal(mu_t, mu)):
                fail(f"14a: K2t is not bit-equal to K2 at {count} systems, n={N}")
        samples, D = k3_inputs(gen, 100, 100, M)
        got = ops.topk_kernel_matrices(samples, D, N)
        ref = topk_kernel_matrices_plain(samples, D, N)
        bad = (got[0] - ref[0]).abs() > 1e-5 * ref[0].abs() + 1e-6
        if not (torch.equal(got[2], ref[2]) and torch.equal(got[1], ref[1])) \
                or bool(bad.any()):
            fail(f"14a: K3 differs from its twin at (100, 100, {M + 1}), k={N}")
    torch.cuda.synchronize()
    log(f"14a: K1 (100, 89, N^2+1) and (1, 100, N^2+1), K5, K2 and K2t at 8,900 and "
        f"10,000 systems, K3 (100, 100, N^2+1) against their twins at N = 2 ... 16: "
        f"indices, one-hot rows and K_red equal, K2t bit-equal to K2, K2 within "
        f"{err:.3e} of float64; {time.perf_counter() - t_phase:.1f} s")

    # b. the record's N = 5 and N = 15 solves under three selections
    def want(path):
        return {k: sum(at.get(path, 0) for at in tables.get(k, {}).values())
                for k in names}

    solvers = {}
    for N in RECORD_SIZES:
        cfg = record_config(N)
        solver = Solver(cfg, device=dev)
        scen = obstacle_scenarios(torch, 4, cfg.obstacles.num_obs, solver.ws.tot_time)
        calls = [(i, (INIT, MEAN, COV, *scen[i], 15.0)) for i in (1, 2, 3)]
        solvers[N] = (cfg, solver, calls)
        xo, yo = obstacle_scenarios(torch, 1, cfg.obstacles.num_obs,
                                    solver.ws.tot_time.cpu(), blocking=True)[0]
        one_iter = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=1))
        for sel in SELECTIONS_F:
            path = f"path_f{N}_{sel}"
            os.environ["MPC_MMD_SELECTION"] = sel
            try:
                check_solve(solver.solve(0, INIT, MEAN, COV, *scen[0], 15.0), cfg)
                expect = want(path)
                got = timed_solves(
                    torch, ops, solver, cfg, calls,
                    f"14b: static beta 0.3, N = {N}, mmd_opt, {sel!r} selection",
                    [fn for fn in ops.KERNELS if expect[fn.__name__]])
                per = {k: v / len(calls) for k, v in got.items()}
                if per != expect:
                    fail(f"14b {path}: launches per solve {per}, but its shapes give "
                         f"{expect}")
                per_solve[path] = per
                path_launches.append(got)
                cuda_vs_cpu(torch, one_iter, (INIT, MEAN, COV, xo, yo, 15.0),
                            f"14b N = {N} {sel}")
            finally:
                os.environ.pop("MPC_MMD_SELECTION")

    # "g" at N = 15: its blocked (C, S', M, M) exponential, 1.8 GB an inner
    # iteration in G_BLOCK_BYTES blocks, once, its time and peak memory
    # logged with no limit on either
    from mpc_mmd_tpu_torch.reduced_set import G_BLOCK_BYTES
    cfg, solver, calls = solvers[15]
    inner = inner_launches(cfg, "g")
    os.environ["MPC_MMD_SELECTION"] = "g"
    try:
        r, secs, got = counted(torch, ops, "14b N = 15 g",
                               kernels_of(ops, inner) + (
                                   ops.noisy_rollout, ops.inner_prologue,
                                   ops.prng_plan, ops.prng_beta),
                               lambda: solver.solve(calls[0][0], *calls[0][1]))
    finally:
        os.environ.pop("MPC_MMD_SELECTION")
    check_solve(r, cfg)
    expect = {k: 0 for k in names}
    expect.update({**inner, **loop_launches(cfg)})
    if got != expect:
        fail(f"14b N = 15 g: launches {got}, expected {expect}")
    path_launches.append(got)
    b, M = cfg.beta_cem, cfg.risk.num_mother
    exp_gb = 4 * cfg.cem.num_batch * (b.num_samples_cem - b.num_ellite) * M * M / 1e9
    log(f"14b: static beta 0.3, N = 15, mmd_opt, 'g' selection, one solve: "
        f"{1e3 * secs:.1f} ms, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB; its exponential "
        f"{exp_gb:.2f} GB an inner iteration in blocks of {G_BLOCK_BYTES // 2**20} "
        f"MB; launches {got}")

    # c. the sweep CLI at both N in mmd_opt and cvar, validate --compare per N
    data, stats = os.path.join(work, "data_f"), os.path.join(work, "stats_f")
    argv = ["--workload", "static", "--costs", "mmd_opt", "cvar", "--noises", "beta",
            "--noise_levels", "0.3", "--num_reduced_sets", *map(str, RECORD_SIZES),
            "--num_obs", "6", "--num_prime", "50", "--num_configs", "4", "--out", data,
            "--device", "cuda"]
    _, secs, got = counted(torch, ops, "14c sweep", (ops.inner_cem, ops.noisy_rollout,
                                                     ops.inner_prologue, ops.prng_plan,
                                                     ops.prng_beta),
                           lambda: sweep_cli.main(argv))
    path_launches.append(got)
    log(f"14c: python -m mpc_mmd_tpu_torch.cli.sweep {' '.join(argv)}: {secs:.1f} s; "
        f"launches {got}")
    for N in RECORD_SIZES:
        roots = {}
        for mode in ("mmd_opt", "cvar"):
            found = [f for tag in (f"{mode}_{N}", f"{mode}_*_{N}")   # budgets, if given
                     for f in glob.glob(os.path.join(data, "static", "*", "*", "*",
                                                     f"{tag}_samples_6_obs"))]
            if len(found) != 1:
                fail(f"14c: expected one {mode} store at N = {N}, found {found}")
            store = ResultStore(found[0])
            if store.meta.get("num_reduced") != N:
                fail(f"14c: the store {found[0]} names num_reduced "
                     f"{store.meta.get('num_reduced')}, not {N}")
            roots[mode] = (found[0], len(store.concatenated().get("cx", ())))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _, vsecs, vgot = counted(torch, ops, f"14c validate --compare N = {N}", (), (
                lambda: validate_cli.main(["--compare", "--data", roots["mmd_opt"][0],
                                           roots["cvar"][0], "--n_mc", "1000", "--out",
                                           stats, "--device", "cuda"])))
        res = json.loads(buf.getvalue())
        path_launches.append(vgot)
        log(f"14c: N = {N}: accepted mmd_opt {roots['mmd_opt'][1]}/4, cvar "
            f"{roots['cvar'][1]}/4; validate --compare --n_mc 1000 in {vsecs:.2f} s: "
            f"n_common {res['n_common']}, collision % "
            f"{ {m: v['coll_pct_mean'] for m, v in res.get('modes', {}).items()} }; "
            f"launches {vgot}")

    # d. the distribution layer's dryrun on the card, a world of one
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mpc_mmd_tpu_torch.parallel",
                           "--device", "cuda"], cwd=HERE, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0 or "dryrun ok" not in proc.stdout:
        fail(f"14d: python -m mpc_mmd_tpu_torch.parallel --device cuda exited "
             f"{proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    log(f"14d: python -m mpc_mmd_tpu_torch.parallel --device cuda: "
        f"{proc.stdout.strip().splitlines()[-1]!r} in {time.perf_counter() - t0:.1f} s")
    log(f"phase 14: {time.perf_counter() - t_phase:.1f} s")
    return path_launches


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA card")
    sys.path.insert(0, HERE)
    try:
        import mpc_mmd_tpu_torch
    except ImportError as e:
        fail(f"the package mpc_mmd_tpu_torch is not beside this script ({e})")
    if not os.path.abspath(mpc_mmd_tpu_torch.__file__).startswith(HERE + os.sep):
        fail(f"imported mpc_mmd_tpu_torch from {mpc_mmd_tpu_torch.__file__}, "
             f"not from {HERE}")
    from mpc_mmd_tpu_torch import (Solver, dynamic_workload, fastrt_workload,
                                   onroad_workload, ops)
    from mpc_mmd_tpu_torch.dynamics import rollout as rollout_plain
    from mpc_mmd_tpu_torch.linalg import eq_qp_solve as qp_plain
    from mpc_mmd_tpu_torch.ops import _build
    from mpc_mmd_tpu_torch.ops.topk import topk_indices_plain, topk_onehot_plain
    from mpc_mmd_tpu_torch.ops.topk_kernel import topk_kernel_matrices_plain
    from mpc_mmd_tpu_torch.scenarios import dynamic_cutin, ego_initial_state

    # ---- 1. the card ------------------------------------------------------
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s)")
    log(f"nvidia-smi: {smi}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    clocks = {}

    def build_clocks():
        try:
            clocks.update(glue_clock_builds())
        except (RuntimeError, OSError) as e:   # nvcc's failure, or none found
            clocks["error"] = e
    clock_build = threading.Thread(target=build_clocks, daemon=True)
    clock_build.start()
    lib_path = _build.build()
    _build.library()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    clock_build.join()
    if "error" in clocks:
        fail(f"the clock and step builds of K4n and kernels (f) and (h) failed: "
             f"{clocks['error']}")
    from mpc_mmd_tpu_torch.utils.kernel_ab import step_cycles
    STEP_CYCLES.update(step_cycles(clocks["step_now"]))
    log(f"critical path of a rollout step, one lane alone: {STEP_CYCLES['k4n']:.1f} "
        f"cycles (K4n's, tan formed), {STEP_CYCLES['k4']:.1f} (K4's, tanf in it); SM "
        f"clock {sm_clock_max_mhz():.0f} MHz at most")
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")

    # ---- 3. kernels against their plain twins -----------------------------
    cfg = fastrt_workload(num_reduced=10, num_obs=6, num_prime=50,
                          mode="mmd_opt", noise="gaussian", noise_level=0.1)
    cfg_a = dynamic_workload(num_reduced=10, num_obs=6, noise="beta",
                             noise_level=0.2, num_prime=50, mode="mmd_opt")
    cfg_d = onroad_workload(num_reduced=4, num_obs=4, num_prime=50,
                            noise="gaussian", noise_level=0.1)
    # Path F: the JAX record's static beta 0.3 cells at N = 5 and 15
    paths_f = {f"path_f{N}_{sel}": (record_config(N), sel)
               for N in RECORD_SIZES for sel in SELECTIONS_F}
    # (each form's first path shape heads its record: fastrt, Path A fused)
    k1_at, k2_at, k2t_at, k3_at, kc_at = launch_shapes({
                                  "fastrt": (cfg, "xla"),
                                  "sweep_mmd_opt": (cfg, "xla"),
                                  "path_a_fused": (cfg_a, "fused"),
                                  "path_a_xla": (cfg_a, "xla"),
                                  "path_d_xla": (cfg_d, "xla"),
                                  "path_d_fused": (cfg_d, "fused"),
                                  "closedloop_mmd_opt": (cfg_d, "xla"),
                                  "path_e_chunk1": (cfg, "xla"),
                                  "path_e_chunk4": (cfg, "xla", 4),
                                  "path_e_chunk8": (cfg, "xla", 8),
                                  "sweep_batch_mmd_opt": (cfg, "xla", 4),
                                  "path_e_fused4": (cfg_a, "fused", 4),
                                  "fastrt_xt": (cfg, "xt"), "path_a_xt": (cfg_a, "xt"),
                                  "path_d_xt": (cfg_d, "xt"), "fastrt_g": (cfg, "g"),
                                  "path_a_g": (cfg_a, "g"), "path_d_g": (cfg_d, "g"),
                                  "fastrt_nocarry": (cfg, "xla", 1, False),
                                  "dist_nccl": (cfg, "xla"),
                                  "dist_mesh_sweep": (cfg, "xla", 4), **paths_f})
    # the draw kernels' shapes, on the paths whose launches per solve are read
    # after a warm-up solve (a fresh solver's first solve adds the
    # solver-fixed draws), and the validator's chunks of 256 and 176 solves
    cfg_b = cfg_a.with_risk_mode("cvar")
    cfg_x, cfg_dx = (c.replace(solve_strategy="exact") for c in (cfg, cfg_d))
    plan_at, draw_at, beta_at = draw_shapes({
        "fastrt": (cfg, False, 1), "path_a_fused": (cfg_a, False, 1),
        "path_a_xla": (cfg_a, False, 1), "path_b_cvar": (cfg_b, False, 1),
        "path_d_xla": (cfg_d, True, 1), "path_d_fused": (cfg_d, True, 1),
        "path_d_det": (cfg_d.with_risk_mode("det"), True, 1),
        "path_e_chunk1": (cfg, False, 1), "path_e_chunk4": (cfg, False, 4),
        "path_e_chunk8": (cfg, False, 8), "path_e_fused4": (cfg_a, False, 4),
        "path_e_cvar4": (cfg_b, False, 4), "path_e_exact": (cfg_x, False, 1),
        "path_d_exact": (cfg_dx, True, 1), "fastrt_xt": (cfg, False, 1),
        "path_a_xt": (cfg_a, False, 1), "path_d_xt": (cfg_d, True, 1),
        "fastrt_g": (cfg, False, 1), "path_a_g": (cfg_a, False, 1),
        "path_d_g": (cfg_d, True, 1), "fastrt_nocarry": (cfg, False, 1),
        **{p: (c, False, 1) for p, (c, _) in paths_f.items()}})
    draw_at[(768, 50_000)] = {"validator_1200": 4}
    draw_at[(528, 50_000)] = {"validator_1200": 1}
    beta_at[(512, 1, 50_000, 50)] = {}          # a validator chunk under Beta noise
    gen = torch.Generator(device=dev).manual_seed(0)
    k1 = check_topk(torch, ops, topk_indices_plain, gen, k1_at)
    log(f"K1 topk_indices: exact at {len(k1_at)} path shapes, edge rows included; "
        f"{k1['ms']:.4f} ms vs plain {k1['plain_ms']:.4f} ms")
    k2 = check_eq_qp(torch, ops, qp_plain, dev, gen, k2_at)
    log(f"K2 eq_qp_solve: max abs err {k2['max_abs_err']:.3e} vs float64 at "
        f"{sorted(k2_at)} systems; {k2['ms']:.4f} ms vs plain {k2['plain_ms']:.4f} ms")
    k2t = check_eq_qp_t(torch, ops, dev, gen, k2t_at)
    log(f"K2 lane-major eq_qp_solve_t: max abs err {k2t['max_abs_err']:.3e} vs "
        f"float64 at {sorted(k2t_at)} systems; {k2t['ms']:.4f} ms vs plain "
        f"{k2t['plain_ms']:.4f} ms")
    # K4 rolls out the validator, the exact strategy and the candidate split
    # (the solve paths' rollouts are K4n's, checked below)
    k4 = check_rollout(torch, ops, rollout_plain, dev, gen,
                       launches_per_solve={"path_e_exact": 10})
    # the on-road shapes: 100 candidates x 16 mother rollouts in mmd_opt, x 4
    # rollouts in cvar / saa / mmd_random (400 lanes end in a partial block)
    k4_onroad = []
    for lanes, paths in ((1600, ("path_d_exact",)), (400, ())):
        k4_onroad.append(check_rollout(
            torch, ops, rollout_plain, dev, gen, lanes=lanes, per_lane=True,
            launches_per_solve={p: cfg_d.cem.maxiter_cem for p in paths} or None))
        log(f"K4 fused_rollout at the on-road shape ({lanes:,} x 50, a state per "
            f"lane): max abs err {k4_onroad[-1]['max_abs_err']:.3e}; "
            f"{k4_onroad[-1]['ms']:.4f} ms vs plain {k4_onroad[-1]['plain_ms']:.4f} ms")
    # Path E's chunks: fastrt's 4 and 8 scenarios x 64 candidates x 100
    # mother rollouts, Path A's 4 x 100 x 100, Path B cvar's 4 x 100 x 10
    # and Path F's: 100 candidates x N^2 mother rollouts at N = 5 and 15
    for lanes, paths in ((25_600, None), (51_200, None), (40_000, None), (4_000, None),
                         *((100 * N * N, None) for N in RECORD_SIZES)):
        k4_onroad.append(check_rollout(torch, ops, rollout_plain, dev, gen,
                                       lanes=lanes, launches_per_solve=paths))
        log(f"K4 fused_rollout at a chunk's or Path F's shape ({lanes:,} x 50): max abs err "
            f"{k4_onroad[-1]['max_abs_err']:.3e}; {k4_onroad[-1]['ms']:.4f} ms vs "
            f"plain {k4_onroad[-1]['plain_ms']:.4f} ms")
    k4 = dict(k4, cases=[k4, *k4_onroad],
              max_abs_err=max(c["max_abs_err"] for c in (k4, *k4_onroad)))
    log(f"K4 fused_rollout: max abs err {k4['max_abs_err']:.3e}; "
        f"{k4['ms']:.4f} ms vs plain {k4['plain_ms']:.4f} ms")
    k4v = check_rollout(torch, ops, rollout_plain, dev, gen, lanes=256_000)
    log(f"K4 fused_rollout at the validator's shape (256,000 x 50): max abs err "
        f"{k4v['max_abs_err']:.3e}; {k4v['ms']:.4f} ms vs plain {k4v['plain_ms']:.4f} ms")
    k3 = check_fused_selection(torch, ops, topk_kernel_matrices_plain, dev, gen, k3_at)
    log(f"K3 topk_kernel_matrices: indices exact, max abs err {k3['max_abs_err']:.3e}; "
        f"{k3['ms']:.4f} ms vs plain {k3['plain_ms']:.4f} ms at (100, 100, 101); "
        f"plain {k3['cases'][1]['plain_ms']:.4f} ms at (100, 100, 17), k=4, "
        f"{k3['cases'][2]['plain_ms']:.4f} ms at (400, 100, 101)")
    k5 = check_topk_onehot(torch, ops, topk_onehot_plain, dev, gen)
    k5_launches = ops.topk_onehot.launches
    log(f"K5 topk_onehot: exact; {k5['ms']:.4f} ms vs plain {k5['plain_ms']:.4f} ms")
    # kernel (c) at every path shape and form, the gaussian and matern52
    # solves of 9g, 11a's chunk of 32 scenarios, "xla" without elite-carry
    # at N = 15 (its elites run again) and 14b's "g" solve at N = 15 (no
    # counted launches there)
    main_kc = (cfg.cem.num_batch, cfg.beta_cem.num_samples_cem, cfg.risk.num_mother,
               cfg.risk.num_reduced, cfg.beta_cem.maxiter)     # fastrt's, first
    xla = ("xla", True)
    kc_forms = check_inner_cem(torch, ops, gen, {
        main_kc + ("laplace",) + xla: kc_at[main_kc + ("laplace",) + xla], **kc_at,
        **{main_kc + (kind,) + xla: {} for kind in ("gaussian", "matern52")},
        (32 * main_kc[0],) + main_kc[1:] + ("laplace",) + xla: {},
        (100, 100, 225, 15, 20, "laplace", "xla", False): {},
        (100, 100, 225, 15, 20, "laplace", "g", True): {}})
    kc = kc_forms["xla"]
    log(f"kernel (c) inner_cem: at {len(kc_at) + 5} shapes and forms within the "
        f"tolerances (every form but 'xla' with elite-carry bit-equal to its chain); "
        f"{kc['ms']:.4f} ms vs plain {kc['plain_ms']:.4f} ms at {kc['shape']}; forms "
        + "; ".join(f"{f} {r['ms']:.4f} ms vs plain {r['plain_ms']:.4f} ms at {r['shape']}"
                    for f, r in kc_forms.items() if f != "xla"))
    # kernels (d) and (e) at every shape and form a path launches them with
    # (each risk mode a form of (e), det's obstacle terms a form of (d)), at
    # 11a's chunk of 32 scenarios and (d)'s obstacle form at a straight
    # 64-row solve with 6 obstacles
    workloads = {"fastrt": (cfg, False), "path_a": (cfg_a, False),
                 "path_d": (cfg_d, True),
                 **{f"f{N}": (record_config(N), False) for N in RECORD_SIZES}}
    on = lambda name, chunk=1: (name, workloads[name][0], workloads[name][1], chunk)
    outer_paths = {
        **{p: on("fastrt") for p in ("fastrt", "sweep_mmd_opt", "path_e_chunk1",
                                     "fastrt_xt", "fastrt_g", "fastrt_nocarry",
                                     "dist_nccl")},
        **{p: on(f"f{c.risk.num_reduced}") for p, (c, _) in paths_f.items()},
        **{p: on("fastrt", 4) for p in ("path_e_chunk4", "sweep_batch_mmd_opt",
                                        "dist_mesh_sweep")},
        "path_e_chunk8": on("fastrt", 8),
        **{p: on("path_a") for p in ("path_a_fused", "path_a_xla", "path_a_xt",
                                     "path_a_g")},
        **{f"path_b_{m}": ("path_a", cfg_a.with_risk_mode(m), False, 1)
           for m in ("cvar", "mmd_random", "saa")},
        "path_e_fused4": on("path_a", 4),
        "path_e_cvar4": ("path_a", cfg_a.with_risk_mode("cvar"), False, 4),
        **{p: on("path_d") for p in ("path_d_xla", "path_d_fused", "closedloop_mmd_opt",
                                     "path_d_xt", "path_d_g")},
        **{p: ("path_d", cfg_d.with_risk_mode(m), True, 1)
           for p, m in (("path_d_cvar", "cvar"), ("path_d_saa", "saa"),
                        ("path_d_mmd_random", "mmd_random"), ("path_d_det", "det"),
                        ("closedloop_cvar", "cvar"), ("closedloop_det", "det"))}}
    kd_at, ke_at = outer_shapes(outer_paths)
    kd_rec = check_outer_project(torch, ops, gen, {
        **kd_at, ("fastrt", 32, False): {}, ("fastrt", 1, True): {}}, workloads)
    log(f"kernel (d) outer_project: at {len(kd_at) + 3} shapes bit-equal (num 60 within "
        f"rtol 1e-5 + atol 1e-6); {kd_rec['ms']:.4f} ms vs plain "
        f"{kd_rec['plain_ms']:.4f} ms at {kd_rec['shape']}")
    ke_rec = check_outer_tail(torch, ops, gen, {**ke_at, ("fastrt", 32, "mmd_opt"): {}},
                              workloads)
    log(f"kernel (e) outer_tail: at {len(ke_at) + 2} shapes and forms bit-equal, indices "
        f"equal; {ke_rec['ms']:.4f} ms vs plain {ke_rec['plain_ms']:.4f} ms "
        f"at {ke_rec['shape']}")
    # K4n, kernels (f) and (g) at every shape a path launches them with; (f)
    # also with the gaussian and matern52 kernels of 9g
    k4n_at, kf_at, kg_at, ks_at = glue_shapes(outer_paths)
    k4n_rec = check_noisy_rollout(torch, ops, gen, k4n_at, workloads, clocks)
    log(f"K4n noisy_rollout: at {len(k4n_at) + 1} shapes bit-equal; {k4n_rec['ms']:.4f} "
        f"ms vs plain {k4n_rec['plain_ms']:.4f} ms at {k4n_rec['shape']}")
    kf_rec = check_inner_prologue(torch, ops, gen, {
        **kf_at, ("fastrt", 1, "gaussian"): {}, ("fastrt", 1, "matern52"): {}}, workloads,
        clocks)
    log(f"kernel (f) inner_prologue: at {len(kf_at) + 3} shapes bit-equal; "
        f"{kf_rec['ms']:.4f} ms vs plain {kf_rec['plain_ms']:.4f} ms at {kf_rec['shape']}")
    kg_rec = check_frenet_points(torch, ops, gen, kg_at, workloads)
    log(f"kernel (g) frenet_points: at {len(kg_at) + 2} shapes and the adversarial inputs "
        f"bit-equal; {kg_rec['ms']:.4f} ms vs plain {kg_rec['plain_ms']:.4f} ms at "
        f"{kg_rec['shape']}")
    ks_rec = check_frenet_states(torch, ops, gen, ks_at, workloads)
    log(f"kernel (g) frenet_states: at {len(ks_at)} on-road modes' shapes and the others "
        f"bit-equal; {ks_rec['ms']:.4f} ms vs plain {ks_rec['plain_ms']:.4f} ms at "
        f"{ks_rec['shape']}")
    ko_at = {p: 1 for p in ("closedloop_mmd_opt", "closedloop_cvar", "closedloop_det")}
    ko_rec = check_frenet_obstacles(torch, ops, gen, workloads, ko_at)
    log(f"kernel (g) frenet_obstacles: bit-equal; {ko_rec['ms']:.4f} ms vs plain "
        f"{ko_rec['plain_ms']:.4f} ms at {ko_rec['shape']}")
    # kernel (h), once a closed-loop step
    kh_at = ko_at
    kh_rec = check_local_frame(torch, ops, dev, kh_at, clocks)
    log(f"kernel (h) local_frame: bit-equal; {kh_rec['ms']:.4f} ms vs plain "
        f"{kh_rec['plain_ms']:.4f} ms at {kh_rec['shape']}")

    # ---- 3b. each kernel's device time, bound and library yardstick -------
    one = torch.zeros(1, device=dev)
    floor_ms = profiled_ms(torch, lambda: one.fill_(1.0), match="")[0]
    log(f"launch floor: fill_ of one float, {floor_ms:.4f} ms device time")
    for name, rec in (("K1", k1), ("K2", k2), ("K2 lane-major", k2t), ("K3", k3),
                      ("K4", k4), ("K4", k4v), ("K5", k5),
                      *((f"kernel (c) {f!r}", r) for f, r in kc_forms.items()),
                      ("kernel (d)", kd_rec), ("kernel (e)", ke_rec), ("K4n", k4n_rec),
                      ("kernel (f)", kf_rec), ("kernel (g)", kg_rec),
                      ("kernel (g) state form", ks_rec),
                      ("kernel (g) obstacle form", ko_rec), ("kernel (h)", kh_rec)):
        measure(torch, name, rec)

    # ---- 4. the full-width fastrt solve -----------------------------------
    t0 = time.perf_counter()
    solver = Solver(cfg, device=dev)
    scen = obstacle_scenarios(torch, 4, cfg.obstacles.num_obs, solver.ws.tot_time)
    r = solver.solve(0, INIT, MEAN, COV, *scen[0], 15.0)
    torch.cuda.synchronize()
    log(f"fastrt warm-up solve: {time.perf_counter() - t0:.2f} s")
    check_solve(r, cfg)
    path_launches = [timed_solves(
        torch, ops, solver, cfg,
        [(i, (INIT, MEAN, COV, *scen[i], 15.0)) for i in range(1, 4)],
        "fastrt (static, gaussian 0.1, xla selection)",
        (ops.inner_cem, ops.inner_prologue, ops.noisy_rollout, ops.prng_plan))]
    per_solve = {"fastrt": {k: v / 3 for k, v in path_launches[-1].items()}}

    # ---- 5. one outer iteration, card against CPU -------------------------
    xo, yo = obstacle_scenarios(torch, 1, cfg.obstacles.num_obs,
                                solver.ws.tot_time.cpu(), blocking=True)[0]
    cuda_vs_cpu(torch, cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=1)),
                (INIT, MEAN, COV, xo, yo, 15.0), "fastrt")

    # ---- 6. Path A: dynamic cut-in, fused selection -----------------------
    init_d, mean_d, cov_d, v_des = ego_initial_state("dynamic")
    cutin = dynamic_cutin(cfg_a, 3, device=dev)
    xs, ys = cutin.x_traj, cutin.y_traj
    os.environ["MPC_MMD_FUSED_CEM"] = "1"
    t0 = time.perf_counter()
    solver_a = Solver(cfg_a, device=dev)
    check_solve(solver_a.solve(0, init_d, mean_d, cov_d, xs[0], ys[0], v_des), cfg_a)
    torch.cuda.synchronize()
    log(f"Path A warm-up solve: {time.perf_counter() - t0:.2f} s")
    calls_a = [(i, (init_d, mean_d, cov_d, xs[i], ys[i], v_des)) for i in (1, 2)]
    inner_a = inner_launches(cfg_a, "fused")
    got = timed_solves(torch, ops, solver_a, cfg_a, calls_a,
                       "Path A (dynamic cut-in, beta 0.2, mmd_opt, fused selection)",
                       kernels_of(ops, inner_a) + (
                           ops.noisy_rollout, ops.inner_prologue, ops.prng_plan,
                           ops.prng_beta))
    want = {**inner_a, **loop_launches(cfg_a)}
    want = {fn.__name__: want.get(fn.__name__, 0) * len(calls_a) for fn in ops.KERNELS}
    if got != want:
        fail(f"Path A launches {got}, expected {want} ({len(calls_a)} solves)")
    path_launches.append(got)
    per_solve["path_a_fused"] = {k: v / len(calls_a) for k, v in got.items()}
    trace_path_a(torch, ops, solver_a, cfg_a, calls_a[0])
    os.environ.pop("MPC_MMD_FUSED_CEM")
    check_solve(solver_a.solve(0, init_d, mean_d, cov_d, xs[0], ys[0], v_des), cfg_a)
    path_launches.append(timed_solves(
        torch, ops, solver_a, cfg_a, calls_a,
        "Path A (dynamic cut-in, beta 0.2, mmd_opt, xla selection)",
        (ops.inner_cem, ops.inner_prologue, ops.noisy_rollout, ops.prng_plan,
         ops.prng_beta)))
    per_solve["path_a_xla"] = {k: v / len(calls_a)
                               for k, v in path_launches[-1].items()}

    # ---- 7. Path B: the same workload in cvar, mmd_random, saa -------------
    for mode, warm, n in (("cvar", True, 2), ("mmd_random", False, 1),
                          ("saa", False, 1)):
        cfg_b = cfg_a.with_risk_mode(mode)
        solver_b = Solver(cfg_b, device=dev)
        if warm:
            check_solve(solver_b.solve(0, init_d, mean_d, cov_d, xs[0], ys[0],
                                       v_des), cfg_b)
        got = timed_solves(torch, ops, solver_b, cfg_b, calls_a[:n],
                           f"Path B (dynamic cut-in, beta 0.2, {mode})",
                           (ops.outer_project, ops.outer_tail, ops.noisy_rollout,
                            ops.prng_plan, ops.prng_beta))
        want = loop_launches(cfg_b, n, fresh=not warm)
        want = {fn.__name__: want.get(fn.__name__, 0) for fn in ops.KERNELS}
        if got != want:
            fail(f"Path B {mode} launches {got}, expected {want} ({n} solves)")
        path_launches.append(got)
        per_solve[f"path_b_{mode}"] = {k: v / n for k, v in got.items()}

    # ---- 8. Path A, one outer iteration, card against CPU -----------------
    os.environ["MPC_MMD_FUSED_CEM"] = "1"
    cuda_vs_cpu(torch, cfg_a.replace(cem=dataclasses.replace(cfg_a.cem, maxiter_cem=1)),
                (init_d, mean_d, cov_d, xs[0].cpu(), ys[0].cpu(), v_des), "Path A")
    os.environ.pop("MPC_MMD_FUSED_CEM")

    checked = lambda rec: {c["shape"]: c["launches_per_solve"]
                           for c in rec["cases"] if c["launches_per_solve"]}

    # ---- 9. Path C: sweep -> validation pipeline ---------------------------
    # ---- 11e runs in Path C's directory, against its pipeline sweep --------
    with tempfile.TemporaryDirectory() as work:
        launches_c, sweeps = path_c(torch, ops, dev, work, per_solve)
        path_launches += launches_c

        # ---- 10. Path D: the on-road stack ---------------------------------
        path_launches += path_d(torch, ops, dev, cfg_d, per_solve)

        # ---- 11. Path E: scenario chunks and the exact strategy ------------
        path_launches += path_e(torch, ops, dev, cfg, cfg_a, cfg_d, work, sweeps,
                                per_solve)

        # ---- 12. the "xt" and "g" selections -------------------------------
        path_launches += path_selections(torch, ops, dev, cfg, cfg_a, cfg_d, per_solve)

        # ---- 13. the distribution layer (against 11e's batch store) --------
        path_launches += path_dist(torch, ops, dev, cfg, work, per_solve)

        # ---- 14. every reduced-set size, the record's N = 5 and 15 cells ----
        shape_tables = {"topk_indices": k1_at, "eq_qp_solve": k2_at,
                        "eq_qp_solve_t": k2t_at, "inner_cem": kc_at,
                        **{name: {key: at for key, at in kc_at.items() if key[6] == f}
                           for f, (name, _, _) in KC_FORMS.items()},
                        "topk_kernel_matrices": checked(k3),
                        "fused_rollout": checked(k4),
                        "prng_draws": draw_at, "prng_plan": plan_at,
                        "outer_project": kd_at,
                        "outer_tail": ke_at, "noisy_rollout": k4n_at,
                        "inner_prologue": kf_at, "frenet_points": kg_at,
                        "frenet_states": ks_at,
                        "frenet_obstacles": {("path_d", cfg_d.obstacles.num_obs): ko_at},
                        "local_frame": {("path_d", cfg_d.frenet.num_path): kh_at},
                        "prng_beta": {k: v for k, v in beta_at.items() if v}}
        path_launches += path_sizes(torch, ops, dev, work, per_solve, shape_tables)

    # ---- 15. the JAX key chain's draws on the card ---------------------------
    kd, kp, kb = path_draws(torch, ops, dev, cfg, draw_at, beta_at, plan_at)

    # ---- 16. the solve as one CUDA graph --------------------------------------
    launches_g, graph_record = path_graph(torch, ops, dev, cfg, cfg_a, cfg_d, per_solve)
    path_launches += launches_g

    # ---- records ----------------------------------------------------------
    launches = {fn.__name__: sum(p[fn.__name__] for p in path_launches)
                for fn in ops.KERNELS}
    launches["topk_onehot"] = k5_launches
    check_launch_shapes(shape_tables, per_solve)
    for path in sorted({p for at in kc_at.values() for p in at}):
        if any(per_solve[path].get(fn.__name__) for fn in (
                ops.topk_indices, ops.eq_qp_solve, ops.eq_qp_solve_t,
                ops.topk_kernel_matrices)):
            fail(f"{path}: a path on kernel (c) launched K1, K2, K2t or K3 "
                 f"({per_solve[path]})")
    record = kernel_record(ops, launches, per_solve, floor_ms, k1, k2, k3, (k4, k4v), k5,
                           k2t, kd, kp, kb, kc, kd_rec, ke_rec, k4n_rec, kf_rec, kg_rec,
                           ks_rec, ko_rec, kh_rec, kc_forms)
    log(f"chip_smoke: {time.perf_counter() - t_start:.0f} s, the build included")
    log(json.dumps({"graph": graph_record}))
    log(json.dumps({"kernels": record}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2])
    else:
        main()
