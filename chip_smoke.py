#!/usr/bin/env python3
"""End-to-end proof on one NVIDIA H100 that the PyTorch port runs.

Run from the root of a checkout: ``python3 chip_smoke.py`` (one GPU,
no arguments; ``--out FILE`` also writes the measurements as JSON).
It imports the port (``fdtd3d_torch``) and torch only, never JAX or the
reference package, and exits non-zero on the first failure:

1. builds every CUDA kernel from ``fdtd3d_torch/csrc`` (one nvcc per
   source, all started together) and holds each kernel against its
   plain PyTorch version on the card. The packed single step (the tail
   of the temporal-blocked pass): one launch of each family at 256^3
   (BASELINE config #3's width, xyz CPML + TFSF, seeded fields), then 10
   whole packed steps of kernels against 10 of plain versions, and the
   same 10 steps at 128^3 with a dielectric sphere (coefficient grids)
   and a Drude sphere (J), and at 96^3 with an oblique plane wave, a
   point source and no CPML on x. The temporal-blocked pass (two steps a
   launch): one launch at 256^3 from seeded fields, psi and incident
   line, then 10 passes at 128^3 with the two spheres, at 96^3 with the
   oblique wave, the point source and no CPML on x, and at 100x90x70
   with xyz CPML and TFSF (a shape the kernel's tile does not divide).
   The gate is the reference's, max |diff| / max |plain| < 2e-6 in f32
   on E, H, psi, J and the incident line;
2. drives the main path through the user's entry point, the port's CLI
   on ``Examples/vacuum3D_tfsf.txt --same-size 256`` for its 150 steps
   with DAT dumps and the finite check, and asserts the temporal-blocked
   CUDA pass ran (75 launches, no packed single step), finite fields in
   the dumps, and scattered-field leakage outside the TFSF box within
   10x of the JAX reference's at a small size on the CPU
   (scripts/tfsf_leakage.py); then the same for 151 steps with a dump
   at step 151: 75 passes and one launch of each packed family (the odd
   step's tail);
3. times each kernel, its plain version and the whole step with CUDA
   events after warm-up at 256^3, beside its bound, and the
   temporal-blocked main path's step under torch.profiler. Here and in
   phases 8, 9 and 13 a ``tb pass`` line gives the tb kernels'
   registers, local (spill) bytes and resident blocks an SM, the pass's
   share of its bound, and its time over two packed steps' kernels
   (e_update + h_update) timed in the same call.

The float32x2 (double-single) path, ``Examples/precision3D_float32x2.txt``:

4. (a) the EFT probe: the ds kernel's own ``two_sum``/``two_prod``
   device functions on seeded (8, 128) inputs with exponents spread
   over 2^-18..2^18, exact in f64, and on subnormal lo words and
   operands near the Dekker split's overflow, the plain version's bits;
   (b) at 256^3 from seeded hi/lo fields 20 steps in: the line kernel
   against the torch ds line ops and the kernel's own record-term
   function against ``record_terms``, bit for bit; one CUDA step (line
   + pass) against one plain step (the reference's schedule in torch
   ops); then 10 whole packed-ds steps of kernels against plain
   versions on the example at 128^3, at 128^3 with an eps sphere and a
   Drude sphere, at 96^3 with a point source and no CPML on x, and in
   vacuum at 128^3 (no slab algebra, no sources); the gates are the
   reference's, on hi and lo words: fields 1e-9 of the family max
   (vacuum 1e-12), psi 1e-6, J 1e-5;
5. (c) the ds main path through the CLI: the example as it stands
   (128^3, 1000 steps) with DAT dumps and the finite check, asserting
   the packed-ds CUDA step ran (1000 line and pass calls, at most 3
   kernels a step) and finite dumps; (d) the same config through the
   port's float64 plain step and through the f32 packed step: rel = max
   over components of |x - f64| / the family's f64 max (hi words), ds
   gated at 2e-7 (the reference's own bar), f32 printed;
6. (e) times at 256^3: the line kernel, the pass and the whole ds step,
   each beside its plain version, by CUDA events, with the pass's
   registers, spills and blocks an SM, beside the bound in bytes and in
   operations (at the non-FMA rate, F32_NONFMA_OPS); then 50 ds steps
   of the main path's 128^3 under torch.profiler (device time, launches
   per step, device busy share).

Batched execution (``--batch``, ``fdtd3d_torch/batch.py``), on the
lane-capable builds of the same two f32 kernels (one launch advances
every lane):

7. (a) 3 lanes at 128^3 from ``Examples/sphere3D_mie.txt`` with
   different eps-sphere and Drude-sphere values (per-lane coefficient
   grids and J), different point-source amplitudes, CPML and an oblique
   plane wave, every carry leaf seeded: one lane-capable tb pass and one
   lane-capable packed step against their plain versions (2e-6), and
   each lane of one tb launch and of one e_update + h_update launch
   against the same kernel run solo on that lane alone, bit for bit;
8. CUDA-event times of the lane-capable tb pass, e_update and h_update
   (beside their plain versions and their bound for all lanes), the
   pass call and the packed step, at 256^3 (vacuum3D_tfsf) for 1, 2 and
   4 lanes;
9. ``Simulation.run_batch`` on 4 lanes of the Mie example as it stands
   (512^3, eps-sphere 2, 4, 6, 9) for one step, which runs the
   lane-capable packed step as the odd step's tail (one launch per
   family, no tb launch; every lane healthy); then, on that batch with
   every leaf seeded, (a)'s checks and (8)'s times at the main path's
   shapes;
10. (b) the batch main path through the CLI: ``--batch`` on four command
   files (the Mie example with ``--eps-sphere`` 2, 4, 6, 9 appended,
   written under ``build/chip_smoke`` at run time) with
   ``--check-finite`` for the file's 800 steps: kind
   ``packed_tb_cuda`` with no ``batch_unsupported`` token, 400 tb
   launches for all four lanes and no packed one, every lane healthy;
   its aggregate Mcells/s and peak memory.

The kernel ladder below packed (``FDTD3D_NO_PACKED``,
``FDTD3D_FORCE_FUSED``, ``FDTD3D_NO_FUSED``), on the two-pass family
kernels (``csrc/family.cu``: two calls a step, ``e_family`` and then
``h_family``, each one kernel for each non-empty section of its
family's work plan) and the recompute-fused pass (``csrc/fused_eh.cu``:
one call a step, one kernel for each non-empty section of its plan),
both with the x slab CPML, the TFSF record terms and the point source in
the kernels:

11. one call of ``e_family``, ``h_family`` and ``fused_eh`` (with the
   record terms and point-source drive of the state's step) against
   their plain versions on seeded inputs, each call's worst error also
   per section (over the cells its items own; the two-pass sections bit
   for bit), then 8 whole two-pass (bit for bit) and fused steps
   against the same steps on the plain versions, at 256^3
   (vacuum3D_tfsf), at 128^3 with the eps and Drude spheres, a point
   source and the TFSF wave, and at the Mie example's 512^3 with its
   coefficient grids; the gate is 2e-6 of each leaf's max;
12. the ladder's main path through the CLI: ``Examples/vacuum3D_tfsf.txt
   --same-size 256`` (150 steps) and ``Examples/sphere3D_mie.txt`` as it
   stands (512^3, 800 steps), each under ``FDTD3D_NO_PACKED`` +
   ``FDTD3D_NO_FUSED`` (kind ``pallas3d_cuda``) and under
   ``FDTD3D_NO_PACKED`` + ``FDTD3D_FORCE_FUSED`` (kind ``fused_cuda``),
   with DAT dumps and the finite check: the kind in the log, one call
   per family a step with its plan's non-empty sections' kernels
   (two-pass, counted as ``family_kernels``) or one call a step with the
   plan's non-empty sections' kernels (fused) and none of the main
   path's kernels, finite dumps, the TFSF leakage of the vacuum
   runs within 10x of the reference's, and the fused and two-pass dumps
   of each configuration within 1e-5 of the family max of each other;
13. at 256^3 (150 steps in) and at the Mie example's 512^3 (200 steps
   in), the main path's shapes and coefficient grids: one launch of each
   ladder kernel and one step of each ladder step against their plain
   versions at 2e-6 of each family's max (each call also per section),
   then same-call CUDA-event times of each ladder call (the two-pass
   ones also launched alone from a prebuilt parameter block) and its
   plain version beside its bound, with the fused kernels' registers,
   spills and blocks an SM and a ``family`` line for the two-pass ones
   (registers, spills, blocks an SM, share of the bound), and of the
   whole two-pass, fused, packed and temporal-blocked steps (the data of
   ``fused_preferred``); both ladder steps at 256^3 under torch.profiler
   (launches a step and device busy share; each must stay within
   ``LADDER_LAUNCHES`` launches a step).

bf16 storage with f32 compute (``--dtype bfloat16``: E and H stored in
bf16, rounded to nearest even where they are stored; the arithmetic, the
CPML psi, Drude J, the incident line and the coefficients in f32), on
the bf16 builds of the same four f32 sources:

14. each bf16 kernel (e_update, h_update, the tb pass, e_family,
   h_family, the fused call) against its plain version: one launch at
   256^3 from seeded fields, then 10 steps at 128^3 with the eps and
   Drude spheres, a point source and the oblique wave; the gates are the
   reference's bf16 ones, 2e-2 of the max (3e-2 for the tb pass), and
   each comparison prints its worst error in bf16 ulps and the share of
   bf16 elements that differ (the fused twin: 0.0);
15. the bf16 main path through the CLI: vacuum3D_tfsf at 256^3 for 150
   steps (75 tb launches, no packed one; finite dumps of 2-byte words,
   manifest dtype "<V2") and 151 (the packed tail), the dumps within
   5e-2 of the family max of phase 2's f32 dumps (the reference's bar,
   tests/test_pallas.py:249), the TFSF leakage printed;
16. at 256^3, 150 steps into a run of each dtype: one launch of each
   bf16 kernel against its plain version, then same-call CUDA-event times
   of each kernel in f32 and in bf16, in turns, beside its bound at its
   storage width (the byte counters with 2-byte fields), the bf16 plain
   versions, the whole steps of both dtypes (Mcells/s), the kernels'
   registers and spills, and the bf16 tb step under torch.profiler;
17. the ladder in bf16: the CLI at 256^3 under both rungs (launches and
   section kernels, the dumps within 5e-2 of the f32 main path's), then
   16's checks (the two-pass calls per section, bit for bit) and times
   on the Mie example at 512^3, 200 steps in, with the ``family`` lines;
18. 3 bf16 lanes at 128^3 (7's batch in bf16): the lane-capable tb pass
   and packed step against their plain versions and each lane against
   the same kernels run solo, bit for bit; 4 bf16 lanes timed at 256^3;
   and the CLI ``--batch`` on the three lanes' command files for 41
   steps (20 tb launches and the packed tail);
19. capacity: vacuum3D_tfsf at 1024^3 through ``Simulation`` for 20
   steps in f32 and in bf16: peak device memory, set-up seconds and
   Mcells/s.

Compensated (Kahan) float32 (bf16 residuals rE/rH, double-single
coefficients and 1/dx, in the packed kernel's two launches) and magnetic
Drude K (the H family's ADE current in the packed, two-pass and fused
kernels):

20. (C1) the compensated e_update/h_update against their plain versions,
   one launch of each and 10 packed steps at the example's 64^3, one
   launch and 2 steps at 256^3: bit for bit; then
   ``Examples/precision3D_compensated.txt`` as it stands through the CLI
   (64^3, 150 steps, a dump at step 150): the packed CUDA step with
   tb_fallback compensated, 150 launches of each family and no other
   kernel, finite dumps, and their error against the port's float64
   plain step and the plain f32 run;
21. (C2) ``Examples/vacuum3D_tfsf.txt --same-size 256`` for 150 steps
   with --compensated and without through the CLI (Mcells/s of each),
   and CUDA-event times of the compensated launches and the f32 ones in
   turns, their plain versions and bounds (the byte counters with the
   residuals), and both packed steps;
22. (C3) ``tests/test_compensated.py:87`` on the card: a 17^3 PEC cavity,
   mode (2, 3, 1), 1000 steps against ``fdtd3d_torch/exact.py``, the
   compensated run on the packed CUDA kernel, f32 on the plain step (the
   reference's gate: e32c < 0.9 e32 and e32c < 2.5e-6) and on the main
   path's kernel (reported);
23. (C4) a double-negative sphere (electric and magnetic Drude on
   ``Examples/sphere3D_mie.txt``'s sphere, omega_p = omega_pm = 1.2 x the
   source's, ``metamaterial1D_dng.txt``'s ratio) at 512^3 through
   ``Simulation`` for 200 steps in f32 and in bf16 on the packed kernel
   (tb_fallback magnetic_drude): ms a step, Mcells/s, peak memory; one
   launch of each family and 8 packed steps against the plain versions
   (2e-6 / 2e-2 of each family's max) and the launches' times;
24. (C5) the same sphere at 256^3 down the ladder in f32 and bf16: one
   launch of e_family/h_family (K) and one fused call and 8 steps of
   each ladder step against the plain versions (bit for bit, the
   two-pass calls per section too), the CLI for 200 steps under
   ``FDTD3D_FORCE_FUSED`` and under ``FDTD3D_NO_PACKED`` +
   ``FDTD3D_NO_FUSED`` (one call a step, or one call of each family a
   step with its plan's section kernels), the launches' times beside
   their bounds and the ``family`` line; and 3 K lanes at 128^3
   (per-lane omega_pm): the lane-capable packed step against its plain
   version and each lane against the same kernels run solo, bit for
   bit, the lane-capable launches' times beside their bound (B times a
   solo launch's bytes), and the lanes through ``run_batch`` for 8
   steps;
25. (C6) 3 compensated lanes at 128^3 (the compensated example's point
   source and CPML, scalar coefficients shared by every lane, every
   carry leaf of each lane, the residuals included, seeded from its own
   seed): one lane-capable compensated e_update + h_update launch and
   one packed step against their plain versions, and each lane against
   the same kernels run solo, all bit for bit; the launches' times
   beside their bound, and the lanes through ``run_batch`` for 8 steps.

Durable runs (npz checkpoints in the reference's format, ``--resume``,
the supervisor's rollback and kernel ladder, the fault plan of
``FDTD3D_FAULT_PLAN``):

26. (a) ``Simulation.checkpoint`` and ``restore`` of vacuum3D_tfsf at
   256^3, 20 steps in, in f32 and bf16: their seconds, the file's MB,
   and the device memory each adds at its peak, gated at one leaf's
   bytes; the restore writes into the live carry's own tensors and
   gives back the checkpointed state bit for bit; (b) the CLI on
   vacuum3D_tfsf at 256^3 for 150 steps with ``--checkpoint-every 50``:
   uninterrupted, then killed at t=100 (a child process under
   ``preempt@t=100``, which must exit non-zero) and resumed with
   ``--resume auto`` (25 tb launches, the remaining steps only), the
   dumps equal byte for byte, in f32 and bf16; in f32 also with the
   newest snapshot damaged (``corrupt_ckpt``), the resume falling back
   to t=50; and ``Examples/precision3D_float32x2.txt`` as it stands
   (128^3, 1000 steps, cadence 250, killed at 500); (c) the supervised
   ladder: ``--supervise --checkpoint-every 10`` with NaNs at t = 20,
   40, 60, 80: the degrades ``packed_tb_cuda`` -> ``packed_cuda`` ->
   ``fused_cuda`` -> ``pallas3d_cuda`` -> ``plain``, each CUDA rung's
   kernels launched, the dumps within ``LADDER_REL`` of the
   uninterrupted run's, the run's wall and peak memory and each
   degrade's, the tripped sim released before the next rung is built
   (one carry on the card at a time); then a trip on the plain step
   re-raises.

Every scheme mode and every output of the CLI (1D/2D runs take the plain
step, as the reference's jnp step; no kernel is new):

27. (a) the four 1D/2D examples (vacuum1D_ezhy, vacuum2D_tmz,
   drude1D_metal, metamaterial1D_dng) as they stand through the CLI on
   the card and on the CPU: the plain step with ``tb_fallback
   packed_ineligible`` and no kernel launched, wall and Mcells/s, the
   dumps' max |component| within ``MODE_NORM_TOL`` of the CPU run's;
   (b) vacuum2D_tmz at 4096^2 for 1000 steps: Mcells/s and peak memory
   above the card's baseline; (c) the Mie example scaled to 256^3 with
   ``--save-formats dat,txt,bmp`` and with ``--save-materials``: each
   writer's seconds and the TXT bytes; a field's and a material's TXT
   and BMP byte-equal to the host writers' output for their DAT dumps'
   values, the first ``TXT_PLAIN_LINES`` TXT lines to the per-value
   Python formatter's.
28. the far field (``--ntff``): (a) the Mie example as it stands (512^3,
   800 steps) with its ``--norms-every 200`` (chunk interval gcd(200, 13)
   = 1: 800 packed steps) and with ``--norms-every 0`` (chunks of 13: 6 tb
   passes and a packed tail), kinds and launches gated against the
   chunking, 31 samples, the device ms and launches a sample, the
   accumulators' bytes, the host seconds of the pattern, profiled
   chunks, and the same sim stepped without sampling (the run without
   ``--ntff``); (b) the example scaled to 256^3 for 1200 steps: the
   kernels' pattern within ``NTFF_PATTERN_TOL`` of the plain step's, and
   bf16's within ``BF16_TRACK`` of f32's (bf16 against f32 at 800 steps
   recorded); (c) a z dipole at 64^3 on the tb pass: the sin^2(theta)
   gates of ``tests/test_exact_ntff.py:111``; (d) the dipole under
   ``--supervise`` with a NaN at t=168: the degrade to the packed step,
   the collector on the live sim, the pattern within ``LADDER_REL`` of
   the uninterrupted run's.

Health counters, the telemetry sink and profiling (no kernel is new: the
health pass is torch ops on views of the carry the kernels leave):

29. (a) the f32 and bf16 main paths (vacuum3D_tfsf at 256^3, 150 and 151
   steps) through the CLI with ``--telemetry --per-chip-telemetry
   --metrics-every 50 --profile``: the tb launches (and the packed tail),
   every record validated, one chunk and one per_chip record a chunk,
   metrics.jsonl at 50/100/150, the profile line; the f32 chunk counters
   against the same sim on the plain step (max |E|/|H| 2e-6, energy
   1e-5 relative, div·E absolute at 1e-5 e_scale / dx), bf16 against f32
   within ``BF16_TRACK``; one device-to-host copy in a 50-step chunk
   with a sink (torch.profiler's Memcpy DtoH events); (b) CUDA-event ms
   and device kernels (from a trace) of one health pass at 256^3 beside
   a tb step, and the 150-step main path's run with the finite check,
   with it and ``--telemetry``, and with neither, three sims in turns,
   min of 5, the overhead gated at ``TELEMETRY_OVERHEAD``; the
   ``--metrics-every`` pass on the Mie example at 256^3 (its ms, the
   bytes it keeps and adds); (c) vacuum3D_tfsf at
   1024^3 f32, 20 steps, without a health pass and with ``--telemetry``:
   the added peak gated at ``HEALTH_PEAK_BYTES``; (d) the 64^3 dipole
   under ``--supervise`` with a NaN and ``--telemetry``: one
   run_start/run_end, the rollback and degrade records (packed_tb_cuda
   -> packed_cuda), the first_unhealthy_t bound; (e) 3 Mie lanes at
   128^3 through ``--batch --telemetry --per-chip-telemetry`` with a NaN
   written into one lane: the batch_lane rows, only that lane
   non-finite, each lane's counters against its solo run; (f) ``--trace
   DIR`` on a 64^3 run: the trace holds the chunk, readback and health
   spans and device kernels.

Complex field values (no kernel is new: a complex run is two real legs,
each on the packed twin ``csrc/packed_eh.cu``, two launches a leg a
step):

30. (a) one paired step, then 10, against the native complex plain step
   on the card from the same seeded complex state, the real and the
   imaginary parts of E, H, psi, J/K and the incident line at ``TOL`` of
   their family's max: vacuum3D_tfsf at 256^3, 128^3 with an eps sphere
   and a Drude sphere, 128^3 with a double-negative sphere (J and K);
   (b) vacuum3D_tfsf at 256^3, 150 steps, ``--complex-field-values``
   through the CLI with DAT dumps, ``--check-finite`` and
   ``--telemetry``: kind ``complex2x_packed_cuda``, token
   ``paired_complex``, 300 launches of each packed family and no tb
   pass, finite ``<c8`` dumps, one run_start/run_end; the same argv
   real under ``FDTD3D_NO_TEMPORAL``: the re parts bit-equal to its
   dumps, the im parts exactly 0; (c) at 256^3 in one call the paired
   step's ms beside the real packed and tb steps', pack and unpack, the
   packed launches on a leg against their plain versions and bounds;
   set-up, Mcells/s and peak memory of 20 complex and 20 real steps at
   256^3 and 512^3; (d) the 64^3 dipole, complex, with ``--ntff``: the
   pattern within ``COMPLEX_PATTERN_TOL`` of the real run's, the im leg
   0; ``--supervise`` with a NaN at t=168: one rollback and one
   degrade, complex kinds on both rungs.

Magnetic Drude K in the float32x2 kernel (``csrc/packed_ds.cu``: K
read and written at the H phase's cell, km/bm inside their box) and
complex float32x2 as two real ds legs on it:

31. (a) 10 CUDA ds steps with K against the plain version at 128^3, the
   DNG sphere of ``dng_flags`` (J and K) and a K sphere on the precision
   example (oblique TFSF), and one step at 256^3 in (c): fields at
   ``DS_FIELD_TOL``, J and K at ``DS_J_TOL``; (b) the DNG sphere at
   128^3, 300 steps, float32x2 against the float64 plain step, gated
   at ``DS_ADE_BAR`` (float32 for contrast); (c) the DNG sphere at
   256^3 in float32x2 through ``Simulation`` (40 steps: ds launches,
   kernels a step, set-up, peak memory), then the line, the pass and
   the step with K and, in the same call, without K (J only) beside
   their plain versions and bounds; (d) the precision example as it
   stands with ``--complex-field-values --telemetry``:
   kind ``complex2x_packed_ds_cuda``, 2 x the real run's ds launches,
   ``<c8`` dumps with the re parts bit-equal to the real float32x2
   run's (phase 5's, or its own under ``--only``) and the im parts 0,
   within ``DS_REL_BAR`` of float64; at 128^3 one paired step with
   both legs seeded against each leg's plain ds step, the paired step
   beside the real ds step in one call, pack and unpack, a leg's
   kernels beside their plain versions; ``--supervise`` at 64^3 with a
   NaN at t=30: one rollback, ``complex2x_packed_ds_cuda ->
   complex2x_plain_ds``.
32. domain decomposition in one process (the sharded packed step,
   ``Simulation(cfg, devices=[...])`` with four or two shards on
   ``cuda:0``): (a) one seeded E launch, one H launch (each after its
   ghost exchange) and one whole step at 256^3 on (2,2,1), each shard
   against the plain versions (f32 at ``TOL``, bf16 at ``BF16_TOL``);
   (b) vacuum3D_tfsf at 256^3 for 150 steps on (2,2,1) and (1,1,2)
   against the unsharded packed run under ``FDTD3D_NO_TEMPORAL`` (every
   leaf, psi on the full axis; bit-equality reported) and the
   unsharded tb run (E, H at ``TOL``), and bf16 on (2,2,1) against the
   unsharded bf16 packed run, each run's sharded launches counted (and
   no unsharded one); on distinct cards too where there are two or
   four, else it says the peer-copy path did not run; (c) the Mie
   example at 256^3 on (2,2,1), 100 steps, against its unsharded packed
   run; (d) same-call CUDA-event times of the sharded step, its two
   exchanges and one shard's E and H launch (beside their plain versions
   and bounds) and of the unsharded packed step, the (2,2,1) run's peak
   memory beside four times ``plan.plan``'s per-shard bytes, and config
   #5's plan on four devices (printed, not run; under 80 GB a device).

33. float32x2 on a decomposed grid (the sharded packed-ds step, four or
   two shards on ``cuda:0``): (b) the precision example as it stands
   (128^3, 1000 steps) on (2,2,1) and (1,1,2), and the DNG sphere of
   ``dng_flags`` at 256^3 in float32x2 (J, K and coefficient grids
   across every shard edge) for 40 steps on (2,2,1), through
   ``Simulation``, each bit-equal on every leaf (lo words and the line
   included, psi on the full axis) to the unsharded ds run (the first
   differing cells printed on a miss), its launches counted (the pass
   on every shard a step, the hi-edge launch on every shard with an
   upper neighbour, the line once a step, no unsharded pass) and its
   peak allocation; (a) on a seeded copy of each (2,2,1) run's state,
   the line once a device, the sharded pass on each shard (after the
   lo pair-ghost exchange) and the hi-edge H launch on each shard with
   an upper neighbour (after the hi exchange) against their plain
   versions, then one whole sharded step against the plain sharded
   step, every gate 0.0; (c) on seeded copies of both runs' states,
   same-call CUDA-event times of the sharded ds step (four shards on
   the card) and the unsharded ds step, the two exchanges, shard 0's
   pass and hi-edge launch beside their plain versions and bounds, and
   the kernels' device ms under torch.profiler; (d) the (2,2,1)
   precision run's peak memory beside four times ``plan.plan``'s
   per-shard bytes.

34. the sharded two-pass family kernels (the sharded builds of
   ``csrc/family.cu``: ghost planes, open walls, full-length psi on a
   thin y/z shard, shard-local records) through the sharded two-pass
   step, four or two shards on ``cuda:0`` under ``FDTD3D_NO_PACKED``:
   (a) on seeded fields at 256^3 on (2,2,1), f32 and bf16, the E launch
   of every shard (after its exchange), the H launch of every shard and
   one whole sharded step against the plain versions shard by shard,
   every gate 0.0; (b) vacuum3D_tfsf at 256^3 for 150 steps on (2,2,1)
   and (1,1,2), f32 and bf16, and the Mie example (512^3) on (2,2,1)
   for 100 steps, each bit-equal on every leaf (psi on the full axis)
   to the unsharded two-pass run of the same argv, its sharded launches
   counted (one of each family a shard a step, no unsharded one) and
   its peak allocation; (c) vacuum3D_tfsf as it stands (64^3, pml 8)
   on (1,4,1), the thin-y case (token ``thin_grid_psi``, full-length y
   psi), from the CLI's configuration through ``Simulation`` (one card
   takes no four-shard CLI run), against the unsharded two-pass run;
   (d) same-call CUDA-event times at 256^3 of the sharded step, its two
   exchanges, shard 0's E and H launch beside their plain versions and
   bounds (the shard's bytes, grids in their box, the ghost planes'
   two components read once), the unsharded two-pass step, the section
   kernels a step under torch.profiler, and the (2,2,1) run's peak
   beside four times ``plan.plan``'s per-shard bytes.

``--only 27,...,34`` (any of them) runs these phases alone after the
build and prints their JSON (no kernels or ok line).

The packed and two-pass kernels' bound counts each coefficient grid
inside the box outside which it holds its background value
(``packed.material``): the kernels read grids there only. The ds
pass's bound counts each grid inside its own such box too; the ds
kernel reads km/bm inside their box and its other grids whole
(``pass_as_read_bytes_ms``). Phase 3 prints the packed kernels'
registers, spills and blocks an SM.

Phases 1, 4, 7, 11, 13, 14, 16-18, 20-25's checks and the checks of 9
(kernel against plain version, lane against solo) launch the kernels
outside the main paths' counts; each main path (phases 2, 5, 9's one
step, 10, each run of 12, 15, 17's CLI runs and 18's, and the CLI and
``Simulation`` runs of 20-24, the ``run_batch`` runs of 24-25,
each CLI run of 26-31 in this process, and each sharded run of 32, 33
and 34)
resets the counts just before it and reads them just after. The last
lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import io as _io
import json
import os
import shutil
import subprocess
import sys
import time
import weakref

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLE = os.path.join(ROOT, "Examples", "vacuum3D_tfsf.txt")
PRECISION = os.path.join(ROOT, "Examples", "precision3D_float32x2.txt")
MIE = os.path.join(ROOT, "Examples", "sphere3D_mie.txt")
OUT_DIR = os.path.join(ROOT, "build", "chip_smoke")

TOL = 2e-6               # the reference's f32 kernel-vs-jnp gate
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
F32_FLOPS = 67e12          # H100 SXM f32 outside the tensor cores
# the same units without FMA (the ds kernels' --fmad=false and explicitly
# rounded intrinsics): 132 SMs x 128 f32 lanes x 1.98 GHz, one op a lane
F32_NONFMA_OPS = 33.5e12
# tfsf_leakage of the JAX reference (jnp step, CPU) on
# Examples/vacuum3D_tfsf.txt at --same-size 48, 150 steps, measured by
# scripts/tfsf_leakage.py; the card's run must stay within 10x of it.
REF_LEAKAGE = 2.506451500547642e-07
STEPS_CMP = 10
# the ladder's fused and two-pass CLI runs of one configuration agree to
# f32 rounding accumulated over the run: ~1e-6 over hundreds of steps,
# gated an order above
LADDER_REL = 1e-5
# device launches a step of each ladder step at 256^3 under the
# profiler: the two incident-line advances and the record terms (17
# torch ops), at most six section kernels (the fused pass's, or the
# two-pass launches' three each) and the run's per-chunk health check
LADDER_LAUNCHES = 25
# the reference's packed-ds gates (tests/test_pallas_packed_ds.py)
DS_FIELD_TOL, DS_VACUUM_TOL, DS_PSI_TOL, DS_J_TOL = 1e-9, 1e-12, 1e-6, 1e-5
DS_REL_BAR = 2e-7         # tests/test_float32x2.py:206
F32_REL_FLOOR = 5e-7      # tests/test_float32x2.py:205
# bf16 storage with f32 compute: the reference's bf16 gates of a kernel
# against its plain version, of the tb kernel, and of a bf16 run against
# the f32 run of the same configuration
BF16_TOL = 2e-2           # tests/test_pallas_packed.py:187
TB_BF16_TOL = 3e-2        # tests/test_pallas_packed_tb.py:161
BF16_TRACK = 5e-2         # tests/test_pallas.py:249
BF16 = ["--dtype", "bfloat16"]
# what -> the worst error of a compare() on bf16 leaves in bf16 ulps and
# the share of their elements that differ at all
BF16_STATS = {}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)


def config(path, extra):
    from fdtd3d_torch import cli
    parser = cli.build_parser()
    return cli.args_to_config(
        parser.parse_args(cli.read_cmd_file(path) + list(extra)))


def seeded_sim(cfg, dev, seed):
    """A Simulation with the packed carry on the card and seeded random
    E, H (and J, K with Drude, the Kahan residuals rE, rH in compensated
    mode, at 1e-10), made on the device from a torch generator."""
    import torch
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    carry = sim._carry
    for key, scale in (("E", 0.01), ("H", 0.01), ("J", 0.01), ("K", 0.01),
                       ("rE", 1e-10), ("rH", 1e-10)):
        if key in carry:
            carry[key].copy_(scale * torch.randn(
                carry[key].shape, generator=g, device=dev))
    return sim


def clone_carry(carry):
    import torch
    if isinstance(carry, dict):
        return {k: clone_carry(v) for k, v in carry.items()}
    return carry.clone() if isinstance(carry, torch.Tensor) else carry


def leaves(carry, prefix=""):
    import torch
    for k, v in carry.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}{k}", v


def compare(got, want, what, family=False, tol=TOL):
    """Max |diff| per leaf, gated at ``tol`` relative to the leaf's max,
    or with ``family`` to the max of its family (the top-level key: E, H,
    psi_E, J, ..., the reference's gate; on a physical state a component
    the wave does not drive holds only rounding noise, which its own max
    cannot scale); returns the largest absolute error. On bf16 leaves it
    also records and prints the worst error in bf16 ulps, of the element
    (the larger of its two values: a cell near zero counts its own tiny
    ulp) and of the scale the gate uses, and the share of elements that
    differ (``BF16_STATS[what]``)."""
    import torch
    worst = 0.0
    want_leaves = dict(leaves(want))
    fam_max = {}
    for name, b in want_leaves.items():
        top = name.split("/")[0]
        fam_max[top] = max(fam_max.get(top, 0.0), float(b.abs().max()))
    ulps, scale_ulps, differ, total = 0.0, 0.0, 0, 0
    for name, a in leaves(got):
        b = want_leaves[name]
        d = (a.float() - b.float()).abs()
        err = float(d.max())
        scale = fam_max[name.split("/")[0]] if family \
            else float(b.abs().max())
        rel = err / scale if scale > 0 else err
        if not rel < tol:
            fail(f"{what}: {name} differs from the plain version: "
                 f"max|diff|={err:.3e}, max|plain|={scale:.3e}, "
                 f"rel={rel:.3e} >= {tol}")
        worst = max(worst, err)
        if a.dtype == torch.bfloat16:
            _, e = torch.frexp(torch.maximum(a.float().abs(),
                                             b.float().abs()))
            ulp = torch.ldexp(torch.ones_like(d), e - 8)  # 8-bit mantissa
            ulps = max(ulps, float((d / ulp).max()))
            if scale > 0:
                _, es = torch.frexp(torch.tensor(scale))
                scale_ulps = max(scale_ulps, err / 2.0 ** (int(es) - 8))
            differ += int((a != b).sum())
            total += a.numel()
            del e, ulp
        del d
    if total:
        BF16_STATS[what] = {"max_bf16_ulps": ulps,
                            "max_bf16_ulps_of_scale": scale_ulps,
                            "share_differing": differ / total}
        say(f"{what}: bf16 fields at most {ulps:g} bf16 ulps of the "
            f"element apart, {scale_ulps:g} ulps of the gate's scale; "
            f"{differ / total:.3e} of their elements differ")
    return worst


def kernel_vs_plain(cfg, dev, seed, label, steps=STEPS_CMP, tol=TOL):
    """``steps`` packed steps with the kernels against as many with the
    plain versions, from the same seeded carry; returns the worst
    error."""
    import torch
    from fdtd3d_torch.ops import packed
    sim = seeded_sim(cfg, dev, seed)
    k_step = packed.make_packed_step(sim.static, dev)
    p_step = packed.make_packed_step(sim.static, dev, plain=True)
    cc = k_step.prepare(sim.coeffs)
    ck = sim._carry
    cp = clone_carry(ck)
    for _ in range(steps):
        ck = k_step(ck, cc)
        cp = p_step(cp, cc)
    torch.cuda.synchronize()
    err = compare(ck, cp, f"{label}: {steps} packed steps", tol=tol)
    say(f"{label}: {steps} kernel steps match the plain version "
        f"(max abs err {err:.3e})")
    return err


def one_launch_vs_plain(sim, fn, plain_fn, family, tol=TOL):
    """One launch of a family's kernel against its plain version on the
    same inputs (the carry of ``sim``, cloned twice)."""
    import torch
    from fdtd3d_torch.ops import packed
    cc = packed.make_packed_step(sim.static, sim.device).prepare(sim.coeffs)
    a, b = clone_carry(sim._carry), clone_carry(sim._carry)
    for carry, f in ((a, fn), (b, plain_fn)):
        if family == "E":
            f(carry["E"], carry["H"], carry.get("J"), carry["psE"], cc["E"],
              carry.get("rE"))
        else:
            f(carry["H"], carry["E"], carry["psH"], cc["H"], carry.get("K"),
              carry.get("rH"))
    torch.cuda.synchronize()
    return compare(a, b, f"one {family} launch "
                   f"({sim.static.cfg.dtype}, {sim.static.grid_shape})",
                   tol=tol)


def seeded_tb_sim(cfg, dev, seed):
    """A temporal-blocked Simulation on the card with every leaf of the
    carry seeded (E, H, psi, J and the incident line), so the first
    pass already reads non-zero psi and record terms."""
    import torch
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(cfg, device=dev)
    if sim.step_kind != "packed_tb_cuda":
        fail(f"{cfg.grid_shape}: ran {sim.step_kind}, not packed_tb_cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    for _, v in leaves(sim._carry):
        v.copy_(0.01 * torch.randn(v.shape, generator=g, device=dev))
    return sim


def tb_vs_plain(cfg, dev, seed, passes, label, tol=TOL):
    """``passes`` temporal-blocked passes with the kernel against as many
    with its plain version, from the same seeded carry; returns the
    worst error."""
    import torch
    from fdtd3d_torch.ops import packed_tb
    sim = seeded_tb_sim(cfg, dev, seed)
    k_step = packed_tb.make_packed_tb_step(sim.static, dev)
    p_step = packed_tb.make_packed_tb_step(sim.static, dev, plain=True)
    cc = k_step.prepare(sim.coeffs)
    ck = sim._carry
    cp = clone_carry(ck)
    for _ in range(passes):
        ck = k_step(ck, cc)
        cp = p_step(cp, cc)
    torch.cuda.synchronize()
    err = compare(ck, cp, f"{label}: {passes} tb passes", tol=tol)
    say(f"{label}: {passes} tb kernel passes match the plain version "
        f"(max abs err {err:.3e})")
    return err


def lanes_of(carry):
    """Lanes of a packed carry: 1 for a solo one (3, n1, n2, n3)."""
    return carry["E"].shape[0] if carry["E"].dim() == 5 else 1


def tb_bytes(carry, cc):
    """Bytes one temporal-blocked pass must move: E, H (and J) read once
    and written once, psi of both families read and written, each
    coefficient grid and profile read once, the record terms read; all
    lanes of a lane-stacked carry. E and H at their storage width (4 or
    2 bytes), everything else f32."""
    import torch
    cells = carry["E"].numel() // 3
    n = 2 * 6 * cells * carry["E"].element_size()
    n += sum(2 * v.numel() * 4 for fam in ("psE", "psH")
             for v in carry[fam].values())
    if "J" in carry:
        n += 2 * 3 * cells * 4
    for fam in ("E", "H"):
        fc = cc[fam]
        for key in ("a", "b", "kj", "bj"):
            for v in fc[key] or []:
                if isinstance(v, torch.Tensor):
                    n += v.numel() * 4
        n += sum(v.numel() * 4 for v in fc["prof"].values())
    plan = cc["tb"]["plan"]
    if plan is not None:
        n += 2 * plan.total * 4 * lanes_of(carry)
    return n


def tb_flops(carry, cc):
    """Flops of one pass: two generations of both families, as counted
    for the packed step, plus one add per record plane cell."""
    plan = cc["tb"]["plan"]
    f = 2 * (family_flops(carry, "E") + family_flops(carry, "H"))
    return f + (2 * plan.total * lanes_of(carry) if plan is not None else 0)


def tb_report(label, tb_ms, bound_ms, packed_ms):
    """One line on the tb pass at a shape: the kernels' registers, local
    (spill) bytes and resident blocks an SM (the CUDA runtime's), the
    pass's share of its bound, and its time over two packed steps'
    kernels (``packed_ms``: e_update + h_update) measured in the same
    call."""
    from fdtd3d_torch.ops import packed_tb
    occ = packed_tb.occupancy()
    rec = {"label": label, "tb_pass_ms": tb_ms, "bound_ms": bound_ms,
           "bound_share": bound_ms / tb_ms,
           "two_packed_steps_ms": 2 * packed_ms,
           "over_two_packed_steps": tb_ms / (2 * packed_ms),
           "kernels": {k: [v["registers"], v["local_bytes"],
                           v["blocks_per_sm"]] for k, v in occ.items()}}
    say("tb pass (registers, local bytes, blocks an SM per kernel): "
        + json.dumps(rec))
    return rec


def timed(fn, reps):
    """Mean ms of fn() over reps calls, by CUDA events after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def grid_cells(fc, whole=False):
    """Cells of each coefficient grid of a packed family that a launch
    must read: the box outside which every grid holds its background
    (``packed.material``: the items outside it read none), or with
    ``whole`` (or "all") the whole grid."""
    from fdtd3d_torch.ops import packed
    grids, _ = packed.material(fc)
    if whole or grids == "all":
        return None
    n = 1
    for lo, hi in grids or ():
        n *= hi - lo + 1
    return n if grids else 0


def family_bytes(carry, cc, family, whole_grids=False):
    """Bytes one family update must move: each input read once, each
    output written once (fields, psi, J, profiles, and the coefficient
    grids inside their box: ``grid_cells``; ``whole_grids``: the whole
    grids, the count before the kernel read grids inside their box
    only); all lanes of a lane-stacked carry. E and H at their storage
    width."""
    import torch
    cells = carry["E"].numel() // 3
    vol = cells * 4
    fvol = cells * carry["E"].element_size()
    n = 3 * fvol                                 # other family, read
    n += 2 * 3 * fvol                            # own family, r + w
    ps = carry["psE"] if family == "E" else carry["psH"]
    n += sum(2 * v.numel() * 4 for v in ps.values())
    if ("J" if family == "E" else "K") in carry:
        n += 2 * 3 * vol                         # the ADE current, r + w
    res = carry.get("rE" if family == "E" else "rH")
    if res is not None:
        n += 2 * res.numel() * 2                 # bf16 residuals, r + w
    fc = cc[family]
    box = grid_cells(fc, whole_grids)
    one = fc["shape"][0] * fc["shape"][1] * fc["shape"][2]
    for key in ("a", "b", "kj", "bj"):
        for v in fc[key] or []:
            if isinstance(v, torch.Tensor):
                n += (v.numel() if box is None
                      else box * (v.numel() // one)) * 4
    n += sum(v.numel() * 4 for v in fc["prof"].values())
    return n


def packed_report(label):
    """One line on the packed kernels: registers, local (spill) bytes and
    resident blocks an SM of each build (the CUDA runtime's)."""
    from fdtd3d_torch.ops import packed
    rec = {"label": label, "kernels": {
        k: [v["registers"], v["local_bytes"], v["blocks_per_sm"]]
        for k, v in packed.occupancy().items()}}
    say("packed kernels (registers, local bytes, blocks an SM): "
        + json.dumps(rec))
    return rec


def family_flops(carry, family):
    """Flops per family update: per component two differences (sub,
    mul, add), the CPML slab terms where psi lives, and the update
    (2 mul + 1 add; the ADE current, J or K, 4 more); in compensated
    mode 2 more a difference (the low word of 1/dx) and 10 more an
    update (the Kahan update against ca E + cb acc); all lanes."""
    cells = carry["E"].numel() // 3
    f = 3 * cells * (2 * 3 + 3)
    ps = carry["psE"] if family == "E" else carry["psH"]
    f += sum(v.numel() * 7 for v in ps.values())
    if ("J" if family == "E" else "K") in carry:
        f += 3 * cells * 4
    if "rE" in carry:
        f += 3 * cells * (2 * 2 + 10)
    return f


# --------------------------------------------------------------------------
# the float32x2 path
# --------------------------------------------------------------------------

def seeded_ds_sim(cfg, dev, seed, warm=0):
    """A packed-ds Simulation on the card, ``warm`` kernel steps in
    (so the incident line carries a wave), then seeded E/H pairs: f64
    draws split into normalised (hi, lo) words, and seeded J and K."""
    import torch
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(cfg, device=dev)
    if sim.step_kind != "packed_ds_cuda":
        fail(f"float32x2 ran {sim.step_kind}, not packed_ds_cuda")
    sim.advance(warm)
    seed_ds_carry(sim._carry, dev, seed)
    return sim


def seed_ds_carry(carry, dev, seed):
    """Seeded E/H pairs in a packed-ds carry, in place: f64 draws split
    into normalised (hi, lo) words; seeded J and K where it has them."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    for key in ("E", "H"):
        v = 0.01 * torch.randn(carry[key][:3].shape, generator=g,
                               device=dev, dtype=torch.float64)
        hi = v.float()
        carry[key][:3].copy_(hi)
        carry[key][3:].copy_((v - hi.double()).float())
    for key in ("J", "K"):
        if key in carry:
            carry[key].copy_(1e-4 * torch.randn(carry[key].shape,
                                                generator=g, device=dev))
    return carry


def compare_ds(got, want, what, field_tol):
    """The reference's packed-ds gates on the packed carries: E and H
    (hi and lo rows) relative to the family's hi max, psi pairs at
    DS_PSI_TOL of the psi hi max, J at DS_J_TOL, the incident line
    pairs at DS_VACUUM_TOL; returns the largest absolute error of the
    pass's leaves (fields, psi, J, K at DS_J_TOL) and, apart, of the
    line's:
    {"pass": x, "line": y}."""
    worst = {"pass": 0.0, "line": 0.0}

    def gate(name, a, b, scale, tol, part="pass"):
        err = float((a - b).abs().max())
        rel = err / scale if scale > 0 else err
        if not rel < tol:
            fail(f"{what}: {name} differs from the plain version: "
                 f"max|diff|={err:.3e}, scale={scale:.3e}, rel={rel:.3e} "
                 f">= {tol}")
        worst[part] = max(worst[part], err)

    for fam in ("E", "H"):
        gate(fam, got[fam], want[fam], float(want[fam][:3].abs().max()),
             field_tol)
    for fam in ("psE", "psH"):
        for a, b in want[fam].items():
            gate(f"{fam}[{a}]", got[fam][a], b, float(b[:2].abs().max()),
                 DS_PSI_TOL)
    for key in ("J", "K"):
        if key in want:
            gate(key, got[key], want[key], float(want[key].abs().max()),
                 DS_J_TOL)
    for k, b in want.get("inc", {}).items():
        scale = float(want["inc"][k.replace("_lo", "")].abs().max())
        gate(f"inc/{k}", got["inc"][k], b, scale, DS_VACUUM_TOL, "line")
    return worst


def ds_kernel_vs_plain(cfg, dev, seed, label, field_tol=DS_FIELD_TOL):
    """10 packed-ds steps with the kernels against 10 with the plain
    versions, from the same seeded carry; returns the worst errors
    (``compare_ds``)."""
    import torch
    from fdtd3d_torch.ops import packed_ds
    sim = seeded_ds_sim(cfg, dev, seed)
    k_step = packed_ds.make_packed_ds_step(sim.static, dev)
    p_step = packed_ds.make_packed_ds_step(sim.static, dev, plain=True)
    cc = k_step.prepare(sim.coeffs)
    ck = sim._carry
    cp = clone_carry(ck)
    for _ in range(STEPS_CMP):
        ck = k_step(ck, cc)
        cp = p_step(cp, cc)
    torch.cuda.synchronize()
    err = compare_ds(ck, cp, f"{label}: {STEPS_CMP} packed-ds steps",
                     field_tol)
    say(f"{label}: {STEPS_CMP} ds kernel steps match the plain version "
        f"(max abs err {max(err.values()):.3e})")
    return err


def ds_one_step_vs_plain(sim, seed=None, what="one ds step (line + pass)"):
    """One step of the CUDA path (line kernel + pass) against one plain
    step (the reference's schedule in torch ops) from the same carry
    (with ``seed``, a copy of it with seeded E/H pairs, J and K:
    ``seed_ds_carry``); returns the worst absolute errors
    (``compare_ds``; 0.0: bit-exact on every leaf)."""
    import torch
    from fdtd3d_torch.ops import packed_ds
    k_step = packed_ds.make_packed_ds_step(sim.static, sim.device)
    p_step = packed_ds.make_packed_ds_step(sim.static, sim.device,
                                           plain=True)
    cc = k_step.prepare(sim.coeffs)
    start = clone_carry(sim._carry)
    if seed is not None:
        seed_ds_carry(start, sim.device, seed)
    a = k_step(clone_carry(start), cc)
    b = p_step(start, cc)
    torch.cuda.synchronize()
    return compare_ds(a, b, what, DS_FIELD_TOL)


def bits_equal(a, b):
    """Two float32 tensors hold the same bit patterns (-0 is not +0)."""
    import torch
    return a.shape == b.shape and bool(
        (a.contiguous().view(torch.int32)
         == b.contiguous().view(torch.int32)).all())


def ds_line_terms_check(sim):
    """The device line and the in-kernel record terms against the torch
    ds ops on the card, bit for bit: ``line_advance`` from the carry's
    line against ``tfsf.advance_einc``/``advance_hinc``, and the
    kernel's own record-term function (``device_terms``) against
    ``record_terms`` of the line between the two advances; returns the
    sizes and the measured max |diff| over the line leaves and terms."""
    import torch
    from fdtd3d_torch.ops import packed_ds, tfsf
    static, inc = sim.static, sim._carry["inc"]
    step = packed_ds.make_packed_ds_step(static, sim.device)
    cc = step.prepare(sim.coeffs)
    table = tfsf.line_source(static.tfsf_setup, static.omega, static.dt)
    t = int(sim._carry["t"])
    dst = {k: torch.empty_like(v) for k, v in inc.items()}
    packed_ds.line_advance(inc, dst, cc, table(t))
    mid = tfsf.advance_einc(dict(inc), sim.coeffs, t, static.dt,
                            static.omega, static.tfsf_setup, source=table)
    want = tfsf.advance_hinc(mid, sim.coeffs, static.tfsf_setup)
    got_terms = packed_ds.device_terms(cc, inc, dst)
    want_terms = packed_ds.record_terms(cc["plan"], mid)
    torch.cuda.synchronize()
    err = float((got_terms - want_terms).abs().max())
    for k in packed_ds.LINE_KEYS:
        err = max(err, float((dst[k] - want[k]).abs().max()))
        if not bits_equal(dst[k], want[k]):
            fail(f"the line kernel's {k} differs from the torch ds ops")
    if not bits_equal(got_terms, want_terms):
        fail(f"the in-kernel record terms differ from record_terms "
             f"(max |diff| {err:.3e})")
    if not float(want_terms.abs().max()) > 0:
        fail("the record terms are all zero: no wave on the line")
    say(f"ds line ({static.tfsf_setup.n_inc} cells) and {cc['plan'].total} "
        "in-kernel record terms bit-equal to the torch ds ops")
    return {"line_cells": static.tfsf_setup.n_inc,
            "record_cells": cc["plan"].total, "bit_equal": True,
            "max_abs_err": err}


def eft_extended_inputs(dev):
    """(a, b) float32 pairs past the wide-exponent probe: subnormal lo
    words against normal and subnormal operands, operands near the
    Dekker split's overflow (4097 a overflows above ~2^115), signed
    zeros."""
    import numpy as np
    import torch
    rng = np.random.default_rng(2)
    n = 1024
    tiny = np.float32(2.0 ** -126)
    sub = (rng.integers(1, 2 ** 23, n).astype(np.float32)
           * np.float32(2.0 ** -149)) * rng.choice([-1, 1], n)
    big = (rng.uniform(1, 2, n) * np.exp2(rng.integers(110, 127, n))
           * rng.choice([-1, 1], n))
    wide = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    small = rng.standard_normal(n) * np.exp2(rng.integers(-80, -60, n))
    a = np.concatenate([sub, sub, big, big, small, wide, [0.0, -0.0]])
    b = np.concatenate([wide, sub, wide, small, small,
                        tiny * rng.standard_normal(n), [-0.0, 1.0]])
    return (torch.tensor(a.astype(np.float32), device=dev),
            torch.tensor(b.astype(np.float32), device=dev))


def eft_probe_check(dev):
    """The kernel's two_sum/two_prod on wide-exponent inputs: s + e and
    p + pe equal a + b and a * b exactly in f64."""
    import numpy as np
    import torch
    from fdtd3d_torch.ops import packed_ds
    rng = np.random.default_rng(1)
    a64, b64 = (rng.standard_normal((8, 128))
                * np.exp2(rng.integers(-18, 18, (8, 128)))
                for _ in range(2))
    a = torch.tensor(a64, dtype=torch.float32, device=dev)
    b = torch.tensor(b64, dtype=torch.float32, device=dev)
    s, e, p, pe = (t.double().cpu().numpy()
                   for t in packed_ds.eft_probe(a, b))
    ad, bd = a.double().cpu().numpy(), b.double().cpu().numpy()
    if not np.array_equal(s + e, ad + bd):
        fail("EFT probe: two_sum in the ds kernel is not exact")
    if not np.array_equal(p + pe, ad * bd):
        fail("EFT probe: two_prod in the ds kernel is not exact")
    say("EFT probe: two_sum and two_prod exact on 1024 wide-exponent "
        "pairs")
    # past exactness: subnormal lo words and operands near the split's
    # overflow, where Dekker's product is not exact but is the
    # reference's; the kernel must give the plain version's bits
    from fdtd3d_torch.ops import ds
    a, b = eft_extended_inputs(dev)
    got = packed_ds.eft_probe(a, b)
    want = ds.two_sum(a, b) + ds.two_prod(a, b)
    for name, g, w in zip(("s", "e", "p", "pe"), got, want):
        same = (g.view(torch.int32) == w.view(torch.int32)) \
            | (torch.isnan(g) & torch.isnan(w))
        if not bool(same.all()):
            fail(f"EFT probe: the ds kernel's {name} differs from the plain "
                 f"version on {int((~same).sum())} extended pairs")
    say(f"EFT probe: two_sum and two_prod give the plain version's bits on "
        f"{a.numel()} subnormal and near-overflow pairs")


def rel_vs_f64(fields, ref):
    """max over components of |x - f64| / the family's f64 max (complex
    fields against a complex or a real reference)."""
    import numpy as np
    scale = {fam: max(np.abs(ref[c]).max() for c in ref if c[0] == fam)
             for fam in "EH"}

    def wide(v):
        return np.asarray(v, np.complex128 if np.iscomplexobj(v)
                          else np.float64)
    return max(float(np.abs(wide(fields[c]) - ref[c]).max() / scale[c[0]])
               for c in ref)


def ds_record_cells(cc, family):
    """Plane cells of the family's TFSF records (their terms are
    computed)."""
    fc = cc[family]
    n = 0
    for rec in fc["records"]:
        if rec.corr is not None:
            shape = list(fc["shape"])
            shape[rec.axis] = 1
            n += shape[0] * shape[1] * shape[2]
    return n


def ds_pass_bytes(carry, cc, as_read=False):
    """Bytes one ds pass must move: each input read once, each output
    written once (E and H: 6 words each read and 6 written; psi pairs,
    J and K read and written; profiles, the record geometry of 7 floats
    and an index a record cell, the line; each coefficient grid, a hi
    or lo word of a/b or plain f32 kj/bj of either family, inside the
    box outside which it holds its background value: ``grid_cells`` of
    that grid alone). ``as_read``: the grids as the kernel reads them,
    km/bm inside the H family's box and every other grid whole."""
    import torch
    vol = carry["E"][0].numel() * 4
    n = 4 * 6 * vol
    for fam in ("psE", "psH"):
        n += sum(2 * v.numel() * 4 for v in carry[fam].values())
    for key in ("J", "K"):
        if key in carry:
            n += 2 * 3 * vol
    for family in ("E", "H"):
        fc = cc[family]
        box = 1
        for lo, hi in fc.get("box") or ():
            box *= hi - lo + 1
        for key in ("a", "b", "kj", "bj"):
            boxed = family == "H" and key in ("kj", "bj")
            for v in fc[key] or []:
                for t in (v if isinstance(v, tuple) else (v,)):
                    if not (isinstance(t, torch.Tensor) and t.dim() > 0):
                        continue
                    if not as_read:
                        n += 4 * grid_cells({"shape": fc["shape"], "a": [t],
                                             "b": None, "kj": None,
                                             "bj": None})
                    elif boxed:
                        n += 4 * (box if fc["box"] else 0)
                    else:
                        n += 4 * t.numel()
        n += sum(v.numel() * 4 for v in fc["prof"].values())
        n += 8 * 4 * ds_record_cells(cc, family)
    if "inc" in carry:
        n += sum(v.numel() * 4 for v in carry["inc"].values())
    return n


def ds_pass_flops(carry, cc):
    """f32 operations of one ds pass, counted from the kernel's EFT
    sequences: per cell and family, per component two differences (40
    each), the sign, the pair sum (20), the coefficient products and
    sum (72); 118 per slab psi pair (three pair products, two pair
    sums); per record cell the term (three pair products, a pair sum,
    the gate: 94) and its pair sum into the accumulator (20); 16 for
    Drude J and 16 for K per component (two products, a sum, add_f)."""
    cells = carry["E"][0].numel()
    f = 2 * 3 * cells * (2 * 40 + 2 + 20 + 72)
    for fam in ("psE", "psH"):
        f += sum(v.numel() // 2 for v in carry[fam].values()) * 118
    f += 114 * (ds_record_cells(cc, "E") + ds_record_cells(cc, "H"))
    for key in ("J", "K"):
        if key in carry:
            f += 3 * cells * 16
    return f


def ds_line_bytes_flops(cc):
    """(bytes, f32 operations) of one line advance: 4 words read and 4
    written, 8 coefficient words a line cell; per cell and half a
    difference (13), two pair products (48) and a pair sum (20)."""
    n = cc["n_inc"]
    return (16 * 4 * n, 2 * 81 * n)


def ds_times(sim, dev, reps, plain_reps):
    """CUDA-event times on ``sim``'s packed-ds state: the line kernel,
    the pass, the whole CUDA step, each beside its plain version, the
    torch record-term ops the pass replaced, and the bounds (bytes at
    HBM_BYTES_PER_S, operations at the non-FMA rate F32_NONFMA_OPS)."""
    import torch
    from fdtd3d_torch.ops import packed, packed_ds, tfsf
    static, carry = sim.static, sim._carry
    dstep = packed_ds.make_packed_ds_step(static, dev)
    dplain = packed_ds.make_packed_ds_step(static, dev, plain=True)
    cc = dstep.prepare(sim.coeffs)
    pair = tfsf.line_source(static.tfsf_setup, static.omega, static.dt)(
        int(carry["t"]))
    inc = carry["inc"]
    line_dst = {k: torch.empty_like(v) for k, v in inc.items()}
    spare = packed.alloc_like(carry)
    point = (0.0, 0.0) if cc["has_point"] else None
    out = {
        "line_ms": timed(lambda: packed_ds.line_advance(inc, line_dst, cc,
                                                        pair), reps),
        "pass_ms": timed(lambda: packed_ds.ds_pass(carry, spare, cc, inc,
                                                   line_dst, point), reps),
        "line_plain_ms": timed(lambda: packed_ds.line_advance_plain(
            inc, line_dst, cc, pair), plain_reps),
        "pass_plain_ms": timed(lambda: packed_ds.ds_pass_plain(
            carry, spare, cc, inc, line_dst, point), plain_reps),
        "record_terms_torch_ms": timed(lambda: packed_ds.record_terms(
            cc["plan"], inc), reps),
        "step_ms": timed(lambda: dstep(carry, cc), reps),
        "plain_step_ms": timed(lambda: dplain(carry, cc), plain_reps)}
    nbytes, nops = ds_pass_bytes(carry, cc), ds_pass_flops(carry, cc)
    lbytes, lops = ds_line_bytes_flops(cc)
    for key, b, o in (("pass", nbytes, nops), ("line", lbytes, lops)):
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = o / F32_NONFMA_OPS * 1e3
        out.update({f"{key}_bytes": b, f"{key}_ops": o,
                    f"{key}_bytes_ms": t_bytes, f"{key}_ops_ms": t_ops,
                    f"{key}_bound_ms": max(t_bytes, t_ops),
                    f"{key}_bound_by": "bytes" if t_bytes >= t_ops
                    else "operations"})
    out["pass_as_read_bytes_ms"] = ds_pass_bytes(
        carry, cc, as_read=True) / HBM_BYTES_PER_S * 1e3
    out["pass_bound_share"] = out["pass_bound_ms"] / out["pass_ms"]
    out["step_bound_share"] = (out["pass_bound_ms"] + out["line_bound_ms"]) \
        / out["step_ms"]
    out["occupancy"] = packed_ds.occupancy()
    return out


def profile_window(sim, steps):
    """``steps`` steps of ``sim`` under torch.profiler: wall and device
    microseconds per step (the sum over device kernels), kernel launches
    per step, the hand-written kernels' microseconds per step, and the
    device busy share (device over wall; the
    profiler's host cost stretches the wall, so it is a lower bound)."""
    wall_us, device_us, launches, per_key = device_launches(
        lambda: sim.advance(steps))
    kernels_us = {k: us / steps for k, us in per_key.items()
                  if any(n in k for n in ("family_update", "family_section",
                                          "tb_section", "family_pass",
                                          "fused_section", "ds_section",
                                          "ds_line"))}
    return {"wall_us_per_step": wall_us / steps,
            "device_us_per_step": device_us / steps,
            "launches_per_step": launches / steps,
            "device_busy_share": device_us / wall_us,
            "kernel_us_per_step": kernels_us}


def device_launches(fn):
    """``fn()`` under torch.profiler: (wall us, device us, device
    launches, device us by kernel name), the device time summed over
    kernels (the profiler's own ``cuda*`` and ``aten::`` rows and the
    port's ``fdtd3d/`` spans left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_us, launches, per_key = 0.0, 0, {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:                      # older torch
            us = ev.self_cuda_time_total
        us = float(us)
        # the port's own spans (fdtd3d/...) hold the kernels launched
        # inside them: counting them too would count those twice
        if us <= 0 or ev.key.startswith(("aten::", "cuda", "fdtd3d/")):
            continue
        device_us += us
        launches += ev.count
        per_key[ev.key] = us
    return wall_us, device_us, launches, per_key


# --------------------------------------------------------------------------
# batched execution: the lane-capable kernels
# --------------------------------------------------------------------------

def mie_args(size, eps, extra=()):
    """Flags of Examples/sphere3D_mie.txt at ``size`` (the sphere centred,
    radius size/8: the file's own at 512) with eps-sphere ``eps``."""
    c, r = str(size // 2), str(size // 8)
    return ["--same-size", str(size), "--eps-sphere", str(eps),
            "--eps-sphere-center-x", c, "--eps-sphere-center-y", c,
            "--eps-sphere-center-z", c, "--eps-sphere-radius", r,
            *extra]


def seed_leaves(carry, dev, seed):
    """Every tensor leaf of a carry to seeded random values (0.01 sigma),
    made on the device."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    for _, v in leaves(carry):
        v.copy_(0.01 * torch.randn(v.shape, generator=g, device=dev))


def lane_batch(cfgs, dev):
    """A BatchSimulation on the card that must ride the lane-capable
    temporal-blocked kernel."""
    from fdtd3d_torch.batch import BatchSimulation
    bsim = BatchSimulation(cfgs, device=dev)
    if bsim.step_kind != "packed_tb_cuda" or bsim.batch_fallback:
        fail(f"batch of {bsim.batch_size}: ran {bsim.step_kind} "
             f"{bsim.batch_fallback or ''}, not the lane-capable "
             f"packed_tb_cuda")
    return bsim


def pass_fields(carry):
    """The buffers a tb pass writes, as a dict for compare()."""
    return {k: carry[k] for k in ("E", "H", "J", "psE", "psH")
            if k in carry}


def solo_lane(carry, lane):
    """Lane ``lane`` of a lane-stacked carry as a solo carry (copies, no
    lane axis)."""
    import torch
    if isinstance(carry, dict):
        return {k: solo_lane(v, lane) for k, v in carry.items()}
    return carry[lane].clone() if isinstance(carry, torch.Tensor) else carry


def solo_tb(tb, lane):
    """The tb operands of one lane of a lane-capable prepare."""
    from fdtd3d_torch.ops import packed
    out = {k: v for k, v in tb.items() if k != "_params"}
    out.update(E=packed.lane_fc(tb["E"], lane),
               H=packed.lane_fc(tb["H"], lane), batch=0)
    return out


def assert_lanes_equal(got, lane, want, what):
    """Every leaf of the solo carry ``want`` equals lane ``lane`` of the
    lane-stacked ``got``, bit for bit."""
    import torch
    got_leaves = dict(leaves(got))
    for name, b in leaves(want):
        if not torch.equal(got_leaves[name][lane], b):
            err = float((got_leaves[name][lane] - b).abs().max())
            fail(f"{what}: lane {lane} {name} differs from the same "
                 f"kernel run solo (max |diff| {err:.3e})")


def lane_kernels_check(bsim, dev, label, tb_tol=TOL, tol=TOL):
    """Phase 7 (a): on the seeded carry of ``bsim``, one lane-capable tb
    pass and one lane-capable packed step (its two launches and the
    patches between them) against their plain versions (TOL), and each
    lane of one tb launch and of one e_update + h_update launch against
    the same kernel run solo (one lane), bit for bit. Returns the worst
    errors (tb pass, packed step)."""
    import torch
    from fdtd3d_torch.ops import packed, packed_tb
    static, B = bsim.static, bsim.batch_size
    carry = bsim._carry
    k_tb = packed_tb.make_packed_tb_step(static, dev, batch=B)
    cc = k_tb.prepare(bsim._coeffs)
    tb = cc["tb"]
    _, terms, drive = packed_tb.generation_terms(static, tb,
                                                 carry.get("inc"),
                                                 carry["t"])
    dst_k = packed.alloc_like(carry)
    dst_p = packed.alloc_like(carry)
    packed_tb.tb_pass(carry, dst_k, tb, terms, drive)
    packed_tb.tb_pass_plain(carry, dst_p, tb, terms, drive)
    torch.cuda.synchronize()
    err_tb = compare(dst_k, dst_p, f"{label}: one lane-capable tb pass",
                     tol=tb_tol)
    for lane in range(B):
        src = solo_lane(pass_fields(carry), lane)
        dst = packed.alloc_like(src)
        packed_tb.tb_pass(src, dst, solo_tb(tb, lane),
                          None if terms is None
                          else terms[:, lane].contiguous(),
                          None if drive is None else drive[lane].tolist())
        torch.cuda.synchronize()
        assert_lanes_equal(dst_k, lane, dst, f"{label}: tb pass")
    del dst_k, dst_p, src, dst
    k_pk = packed.make_packed_step(static, dev, batch=B)
    p_pk = packed.make_packed_step(static, dev, plain=True, batch=B)
    pcc = k_pk.prepare(bsim._coeffs)
    ck, cp = clone_carry(carry), clone_carry(carry)
    k_pk(ck, pcc)
    p_pk(cp, pcc)
    torch.cuda.synchronize()
    err_pk = compare(ck, cp, f"{label}: one lane-capable packed step",
                     tol=tol)
    del ck, cp
    for fc_lane in (None,) + tuple(range(B)):
        if fc_lane is None:
            a = pass_fields(clone_carry(carry))
            fe, fh = pcc["E"], pcc["H"]
        else:
            a = solo_lane(pass_fields(carry), fc_lane)
            fe = packed.lane_fc(pcc["E"], fc_lane)
            fh = packed.lane_fc(pcc["H"], fc_lane)
        packed.e_update(a["E"], a["H"], a.get("J"), a["psE"], fe)
        packed.h_update(a["H"], a["E"], a["psH"], fh)
        torch.cuda.synchronize()
        if fc_lane is None:
            batched = a
        else:
            assert_lanes_equal(batched, fc_lane, a,
                               f"{label}: e_update + h_update")
    say(f"{label}: the lane-capable tb pass ({err_tb:.3e}) and packed step "
        f"({err_pk:.3e}) match their plain versions; every lane equals "
        f"the same kernels run solo, bit for bit")
    return err_tb, err_pk


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def lane_times(bsim, dev, reps, plain_reps):
    """CUDA-event times of the lane-capable kernels on ``bsim``'s carry:
    one tb pass, one e_update and one h_update launch (each beside its
    plain version and its bound for all lanes), the whole pass call
    (kernel + incident line + record terms) and the whole packed step."""
    from fdtd3d_torch.ops import packed, packed_tb
    static, B = bsim.static, bsim.batch_size
    carry = bsim._carry
    k_tb = packed_tb.make_packed_tb_step(static, dev, batch=B)
    cc = k_tb.prepare(bsim._coeffs)
    spare = packed.alloc_like(carry)
    _, terms, drive = packed_tb.generation_terms(static, cc["tb"],
                                                 carry.get("inc"),
                                                 carry["t"])
    out = {"lanes": B, "shape": list(static.grid_shape)}
    out["tb_pass_ms"] = timed(lambda: packed_tb.tb_pass(
        carry, spare, cc["tb"], terms, drive), reps)
    out["tb_plain_ms"] = timed(lambda: packed_tb.tb_pass_plain(
        carry, spare, cc["tb"], terms, drive), plain_reps)
    out["tb_bound_ms"], out["tb_bound_by"] = bound(tb_bytes(carry, cc),
                                                   tb_flops(carry, cc))
    del spare
    for fam, fn, plain_fn, args in (
            ("E", packed.e_update, packed.e_update_plain,
             (carry["E"], carry["H"], carry.get("J"), carry["psE"],
              cc["E"])),
            ("H", packed.h_update, packed.h_update_plain,
             (carry["H"], carry["E"], carry["psH"], cc["H"]))):
        key = fam.lower()
        out[f"{key}_update_ms"] = timed(lambda: fn(*args), reps)
        out[f"{key}_plain_ms"] = timed(lambda: plain_fn(*args), plain_reps)
        out[f"{key}_bound_ms"], out[f"{key}_bound_by"] = bound(
            family_bytes(carry, cc, fam), family_flops(carry, fam))
    out["pass_call_ms"] = timed(lambda: k_tb(carry, cc), reps)
    out["packed_step_ms"] = timed(lambda: k_tb.tail_step(carry, cc), reps)
    cells = float(static.grid_shape[0] * static.grid_shape[1]
                  * static.grid_shape[2])
    out["mcells_per_s_aggregate"] = B * cells * 2 / (
        out["pass_call_ms"] * 1e-3) / 1e6
    return out


def batch_cli_path(paths, label):
    """The batch main path through the CLI: ``--batch`` on the lanes'
    command files with the finite check, kernel launch counts set to 0
    just before it and read just after; its lines, launches, aggregate
    Mcells/s and peak memory."""
    import re

    import torch
    from fdtd3d_torch import cli
    from fdtd3d_torch.ops import packed, packed_tb
    packed.e_update.launches = 0
    packed.h_update.launches = 0
    packed_tb.tb_pass.launches = 0
    torch.cuda.reset_peak_memory_stats()
    captured = _io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(captured):
        rc = cli.main(["--batch", *paths, "--check-finite"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"tb_pass": packed_tb.tb_pass.launches,
                "e_update": packed.e_update.launches,
                "h_update": packed.h_update.launches}
    peak = torch.cuda.max_memory_allocated()
    lines = captured.getvalue().strip().splitlines()
    say(f"cli --batch ({label}): " + " | ".join(lines))
    if rc != 0:
        fail(f"cli.main --batch returned {rc}")
    head = [ln for ln in lines if ln.startswith("batch: ")]
    if head != [f"batch: {len(paths)} lanes step_kind=packed_tb_cuda"]:
        fail(f"{label}: the batch did not ride the lane-capable kernel "
             f"alone: {head}")
    verdicts = [ln for ln in lines if ln.startswith("batch lane ")]
    if verdicts != [f"batch lane {i}: healthy" for i in range(len(paths))]:
        fail(f"{label}: not every lane is healthy: {verdicts}")
    done = [ln for ln in lines if ln.startswith("done: ")]
    m = re.search(r"in ([0-9.]+)s \(([0-9.]+) Mcells/s aggregate", done[0]) \
        if done else None
    if m is None:
        fail(f"{label}: no closing line")
    return {"lanes": len(paths), "launches": launches,
            "stepping_s": float(m.group(1)),
            "mcells_per_s_aggregate": float(m.group(2)),
            "cli_wall_s": wall, "peak_mem_bytes": peak, "lines": lines}


def cli_main_path(steps, cfg256, dtype="float32"):
    """The CLI on vacuum3D_tfsf at 256^3 for ``steps`` steps in
    ``dtype``, one DAT dump at the last step, with the finite check: the
    kernel launches of that run (counts set to 0 just before it), its
    wall, peak memory, the TFSF leakage of its dumps (gated in f32; bf16
    storage floors the scattered field at its own rounding) and, under
    ``fields``, the dumps (bf16: 2-byte words, manifest dtype "<V2",
    read back widened to f32)."""
    import torch
    from fdtd3d_torch import cli, diag
    from fdtd3d_torch.io import BF16_DTYPE, load_dat
    from fdtd3d_torch.ops import packed, packed_tb
    from fdtd3d_torch.solver import build_static
    out_dir = os.path.join(OUT_DIR, f"main_{dtype}_{steps}")
    packed.e_update.launches = 0
    packed.h_update.launches = 0
    packed_tb.tb_pass.launches = 0
    torch.cuda.reset_peak_memory_stats()
    captured = _io.StringIO()
    argv = ["--cmd-from-file", EXAMPLE, "--same-size", "256",
            "--time-steps", str(steps), "--save-res", str(steps),
            "--check-finite", "--save-dir", out_dir, "--dtype", dtype]
    t0 = time.time()
    with contextlib.redirect_stdout(captured):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"tb_pass": packed_tb.tb_pass.launches,
                "e_update": packed.e_update.launches,
                "h_update": packed.h_update.launches}
    peak = torch.cuda.max_memory_allocated()
    log_txt = captured.getvalue()
    say(f"cli ({steps} steps): " + " | ".join(log_txt.strip().splitlines()))
    if rc != 0:
        fail(f"cli.main returned {rc}")
    if "step_kind=packed_tb_cuda" not in log_txt:
        fail("the CLI did not run the temporal-blocked CUDA pass")
    fields = {}
    for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        path = os.path.join(out_dir, f"{c}_t{steps:06d}.dat")
        if not os.path.exists(path):
            fail(f"missing dump {path}")
        fields[c] = load_dat(path)
        if fields[c].shape != (256, 256, 256) \
                or not bool((abs(fields[c]) < float("inf")).all()):
            fail(f"{c}: bad dump (shape {fields[c].shape} or non-finite)")
        if dtype == "bfloat16":
            with open(path + ".manifest.json") as f:
                manifest = json.load(f)
            if manifest["dtype"] != BF16_DTYPE \
                    or os.path.getsize(path) != 2 * 256 ** 3:
                fail(f"{c}: the bf16 dump is not 2-byte words "
                     f"({manifest['dtype']}, {os.path.getsize(path)} B)")
    st = build_static(cfg256).tfsf_setup
    leak = diag.tfsf_leakage(fields, st.lo, st.hi)
    if dtype == "float32" and not leak <= 10 * REF_LEAKAGE:
        fail(f"{steps} steps: TFSF leakage {leak:.3e} exceeds 10x the "
             f"reference's {REF_LEAKAGE:.3e}")
    say(f"main path ({dtype}): {steps} steps, launches {launches}, "
        f"leakage {leak:.3e} (f32 reference at 48^3: {REF_LEAKAGE})")
    return {"dtype": dtype, "steps": steps, "wall_s": wall,
            "launches": launches, "tfsf_leakage": leak,
            "ref_tfsf_leakage_48": REF_LEAKAGE, "peak_mem_bytes": peak,
            "fields": fields}


# --------------------------------------------------------------------------
# the kernel ladder below packed: the two-pass and recompute-fused twins
# --------------------------------------------------------------------------

LADDER_ENV = ("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED", "FDTD3D_FORCE_FUSED")


@contextlib.contextmanager
def ladder_env(*names):
    """The ladder's variables set to 1 (``names``) or unset for the
    block, restored after."""
    saved = {k: os.environ.get(k) for k in LADDER_ENV}
    for k in LADDER_ENV:
        os.environ.pop(k, None)
    for k in names:
        os.environ[k] = "1"
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def ladder_launches():
    """The ladder kernels' counts, and the f32 main path's (which a run
    down the ladder must leave at 0)."""
    from fdtd3d_torch.ops import packed, packed_tb, pallas3d, pallas_fused
    return {"e_family": pallas3d.e_family.launches,
            "h_family": pallas3d.h_family.launches,
            "family_kernels": pallas3d.e_family.kernels
            + pallas3d.h_family.kernels,
            "fused_eh": pallas_fused.fused_eh.launches,
            "fused_eh_kernels": pallas_fused.fused_eh.kernels,
            "tb_pass": packed_tb.tb_pass.launches,
            "e_update": packed.e_update.launches,
            "h_update": packed.h_update.launches}


def reset_launches():
    """Every kernel count of the port to 0."""
    from fdtd3d_torch.ops import packed, packed_ds, packed_tb, pallas3d
    from fdtd3d_torch.ops import pallas_fused
    for fn in (packed.e_update, packed.h_update, packed_tb.tb_pass,
               packed_ds.line_advance, packed_ds.ds_pass, pallas3d.e_family,
               pallas3d.h_family, pallas_fused.fused_eh,
               packed.e_update_sharded, packed.h_update_sharded,
               packed_ds.ds_pass_sharded, packed_ds.hi_edge_h,
               pallas3d.e_family_sharded, pallas3d.h_family_sharded):
        fn.launches = 0
    packed_ds.ds_pass.kernels = pallas_fused.fused_eh.kernels = 0
    packed_ds.ds_pass_sharded.kernels = 0
    pallas3d.e_family.kernels = pallas3d.h_family.kernels = 0
    pallas3d.e_family_sharded.kernels = pallas3d.h_family_sharded.kernels = 0


def seeded_dict_state(cfg, dev, seed):
    """(static, device coefficients, dict-form state on the card with
    every leaf seeded: E, H, psi, J and the incident line)."""
    from fdtd3d_torch.solver import (build_coeffs, build_static,
                                     coeffs_to_device, init_state)
    static = build_static(cfg)
    coeffs = coeffs_to_device(build_coeffs(static), dev)
    state = init_state(static, dev)
    seed_leaves(state, dev, seed)
    return static, coeffs, state


def family_args(static, coeffs, state):
    """The two-pass launches' arguments on a state, as its step makes
    them: (e_family's (E, H, psi_E, J, operands, record terms, drive),
    h_family's (H, E, psi_H, operands, K, record terms)), the record
    terms after the state's E-incident advance (``fused_args``)."""
    E, H, pe, ph, J, fp, terms, drive, K = fused_args(static, coeffs, state)
    return (E, H, pe, J, fp, terms, drive), (H, E, ph, fp, K, terms)


def as_tree(outs, names):
    return {n: o for n, o in zip(names, outs) if o is not None}


def fused_args(static, coeffs, state):
    """The fused call's arguments on a state, as its step makes them:
    old E, H, the psi of every slab axis, J, the prepared operands, the
    record terms after the state's E-incident advance, the point
    source's drive, K."""
    from fdtd3d_torch.ops import pallas3d, tfsf
    fp = pallas3d.prepare(static, coeffs)
    terms = None
    if static.tfsf_setup is not None:
        inc = tfsf.advance_einc(state["inc"], coeffs, state["t"], static.dt,
                                static.omega, static.tfsf_setup)
        terms = tfsf.record_terms(fp["plan"], inc)
    psi = [{k: state[key][k] for v in pallas3d.kernel_psi_terms(
        static, fam).values() for _, k in v}
        for key, fam in (("psi_E", "E"), ("psi_H", "H"))]
    return (state["E"], state["H"], psi[0], psi[1], state.get("J"), fp,
            terms, pallas3d.point_drive(static, fp, state["t"]),
            state.get("K"))


FUSED_OUTS = ("E", "H", "psi_E", "psi_H", "J", "K")


def fused_section_errors(fp, got, want):
    """The fused call's worst absolute error on E and H over the cells
    each section's items own: section name -> error (None when the plan
    has no item there)."""
    from fdtd3d_torch.ops import pallas_fused
    first = next(iter(got["E"].values()))
    rows, counts = pallas_fused.device_plan(fp, first.device)
    return section_errors(rows, counts, pallas_fused.SECTIONS, got, want,
                          ("E", "H"))


def family_section_errors(fp, family, got, want):
    """A two-pass launch's worst absolute error on its family over the
    cells each section's items own (its plan on the card, as the launch
    cached it): section name -> error (None when empty)."""
    from fdtd3d_torch.ops import pallas3d
    rows, counts = fp[f"_plan_{family}"][1]
    return section_errors(rows, counts, pallas3d.SECTIONS, got, want,
                          (family,))


def section_errors(rows, counts, names, got, want, fams):
    """The worst absolute error over the fields ``fams`` of ``got``
    against ``want`` on the cells each section's items own."""
    import torch
    first = next(iter(got[fams[0]].values()))
    rows = rows.cpu().numpy()
    owner = torch.full(first.shape, -1, dtype=torch.int8,
                       device=first.device)
    q0 = 0
    for q, n in enumerate(counts):
        for j0, k0, ny, nz, x0, x1 in rows[q0:q0 + n, :6]:
            owner[x0:x1, j0:j0 + ny, k0:k0 + nz] = q
        q0 += n
    out = {}
    for q, name in enumerate(names):
        if not counts[q]:
            out[name] = None
            continue
        mask = owner == q
        out[name] = max(float(((got[f][c].float() - want[f][c].float())
                               .abs() * mask).max())
                        for f in fams for c in got[f])
    return out


def fused_sections_per_step(static, dev):
    """Non-empty sections of the fused pass's plan for ``static`` on
    the card: its kernels a step."""
    import torch
    from fdtd3d_torch.ops import packed_tb, pallas_fused
    from fdtd3d_torch.solver import slab_axes
    m = tuple(slab_axes(static).get(a, 0) for a in range(3))
    recs = packed_tb.tfsf_records(static)
    records = [(r.axis, r.plane) for fam in ("E", "H") for r in recs[fam]]
    ps = static.cfg.point_source
    point = tuple(ps.position) if ps.enabled else None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, counts = pallas_fused.plan_items(tuple(static.grid_shape), m,
                                        records, point, sms=sms)
    return sum(n > 0 for n in counts)


def family_sections_per_step(static, dev):
    """Non-empty sections of the two-pass launches' plans for ``static``
    on the card (the default build's tile): their kernels a step."""
    import torch
    from fdtd3d_torch.ops import packed_tb, pallas3d
    from fdtd3d_torch.solver import slab_axes
    shape = tuple(static.grid_shape)
    m = tuple(slab_axes(static).get(a, 0) for a in range(3))
    recs = packed_tb.tfsf_records(static)
    ps = static.cfg.point_source
    tile = pallas3d.default_tile(static.cfg.dtype == "bfloat16", shape[2])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n = 0
    for fam in ("E", "H"):
        point = tuple(ps.position) if ps.enabled and fam == "E" else None
        _, counts = pallas3d.plan_items(
            shape, m, [(r.axis, r.plane) for r in recs[fam]], point,
            tile[:2], sms)
        n += sum(c > 0 for c in counts)
    return n


FAMILY_OUTS = {"e_family": ("E", "psi", "J"), "h_family": ("H", "psi", "K")}


def family_calls(static, coeffs, st):
    """(name, kernel wrapper, plain version, arguments, output names) of
    the two-pass launches on a state (``family_args``)."""
    from fdtd3d_torch.ops import pallas3d
    e_args, h_args = family_args(static, coeffs, st)
    return (("e_family", pallas3d.e_family, pallas3d.e_family_plain, e_args,
             FAMILY_OUTS["e_family"]),
            ("h_family", pallas3d.h_family, pallas3d.h_family_plain, h_args,
             FAMILY_OUTS["h_family"]))


def family_sections_check(label, name, args, got, want):
    """Each section kernel of a two-pass launch against the plain
    version on the cells its items own: printed; the launch is built
    without FMA contraction and must reproduce the plain version's bits
    in every section."""
    fam = name[0].upper()
    errs = family_section_errors(args[4] if fam == "E" else args[3], fam,
                                 got, want)
    say(f"{label}: one {name} launch per section, max abs err "
        + json.dumps(errs))
    if any(v for v in errs.values()):
        fail(f"{label}: a {name} section kernel differs from the plain "
             f"version: {errs}")
    return errs


def family_launch_ms(name, args, reps):
    """CUDA-event ms of one two-pass launch from one prebuilt parameter
    block (no host set-up timed; ``name``: e_family or h_family)."""
    from fdtd3d_torch.ops import pallas3d
    lib = pallas3d._library()
    fam = name[0].upper()
    if fam == "E":
        F, S, psi, J, fp, terms, drive = args
    else:
        F, S, psi, fp, J, terms = args
        drive = None
    first = F[fp[fam]["comps"][0]]
    prm = pallas3d._params(F, S, psi, J, fp, fam, terms, drive,
                           *pallas3d.launch_geometry(lib, first,
                                                     fp["shape"][2]))[0]
    fn = "fdtd_e_family" if fam == "E" else "fdtd_h_family"
    return timed(lambda: pallas3d.launch(lib, fn, prm, first.device), reps)


def family_report(label, times, suffix=""):
    """One line on the two-pass launches at a shape: the kernels'
    registers, local (spill) bytes and resident blocks an SM (the CUDA
    runtime's), each launch's ms (its wrapper, and the launch alone),
    its bound and its share of the bound. ``times``: a phase's dict with
    ``{name}{suffix}_ms``, ``_launch_ms`` and ``_bound_ms`` keys."""
    from fdtd3d_torch.ops import pallas3d
    rec = {"label": label, "kernels": {
        k: [v["registers"], v["local_bytes"], v["blocks_per_sm"]]
        for k, v in pallas3d.occupancy().items()}}
    for name in ("e_family", "h_family"):
        k = f"{name}{suffix}"
        if f"{k}_ms" not in times:
            continue
        rec[k] = {"ms": times[f"{k}_ms"],
                  "launch_ms": times.get(f"{k}_launch_ms"),
                  "bound_ms": times[f"{k}_bound_ms"],
                  "bound_share": times[f"{k}_bound_ms"] / times.get(
                      f"{k}_launch_ms", times[f"{k}_ms"])}
    say("family (registers, local bytes, blocks an SM per kernel; ms, "
        "bound, share): " + json.dumps(rec))
    return rec


def ladder_vs_plain(cfg, dev, seed, label, steps=8, tol=TOL):
    """Phase 11: one launch of e_family, h_family (each per section, bit
    for bit) and one fused_eh call (also per section) against their
    plain versions on seeded inputs with the state's record terms and
    drive, then ``steps`` whole steps of the two-pass (bit for bit) and
    the fused step against the same steps on the plain versions, from
    one seeded state (the steps do not mutate it); the worst absolute
    errors per kernel."""
    import torch
    from fdtd3d_torch.ops import pallas3d, pallas_fused
    static, coeffs, st = seeded_dict_state(cfg, dev, seed)
    fargs = fused_args(static, coeffs, st)
    err = {}
    for name, fn, plain, args, outs in family_calls(static, coeffs, st) + (
            ("fused_eh", pallas_fused.fused_eh, pallas_fused.fused_eh_plain,
             fargs, FUSED_OUTS),):
        got = as_tree(fn(*args), outs)
        want = as_tree(plain(*args), outs)
        torch.cuda.synchronize()
        err[name] = compare(got, want, f"{label}: one {name} launch",
                            tol=tol)
        if name == "fused_eh":
            say(f"{label}: one fused_eh call per section, max abs err "
                + json.dumps(fused_section_errors(fargs[5], got, want)))
        else:
            family_sections_check(label, name, args, got, want)
            if err[name] != 0.0:
                fail(f"{label}: one {name} launch is not bit-equal to its "
                     f"plain version ({err[name]:.3e})")
    for name, build_step in (("pallas3d", pallas3d.make_pallas_step),
                             ("fused", pallas_fused.make_fused_eh_step)):
        k_step = build_step(static, dev)
        p_step = build_step(static, dev, plain=True)
        cc = k_step.prepare(coeffs)
        sk = sp = st
        for _ in range(steps):
            sk = k_step(sk, cc)
            sp = p_step(sp, cc)
        torch.cuda.synchronize()
        key = "e_family" if name == "pallas3d" else "fused_eh"
        e = compare(sk, sp, f"{label}: {steps} {k_step.kind} steps", tol=tol)
        if name == "pallas3d" and e != 0.0:
            fail(f"{label}: {steps} two-pass steps are not bit-equal to "
                 f"the plain steps ({e:.3e})")
        err[key] = max(err[key], e)
        del sk, sp
    say(f"{label}: one launch and {steps} steps of each ladder kernel match "
        f"the plain versions (max abs err {json.dumps(err)})")
    return err


def load_dumps(out_dir, steps, shape, label):
    from fdtd3d_torch.io import load_dat
    fields = {}
    for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        path = os.path.join(out_dir, f"{c}_t{steps:06d}.dat")
        if not os.path.exists(path):
            fail(f"{label}: missing dump {path}")
        fields[c] = load_dat(path)
        if fields[c].shape != tuple(shape) \
                or not bool((abs(fields[c]) < float("inf")).all()):
            fail(f"{label}: {c}: bad dump (shape {fields[c].shape} or "
                 f"non-finite)")
    return fields


def run_cli(label, argv, kind, fallback, shape, steps):
    """One CLI run (``argv`` plus a DAT dump at its last step and the
    finite check), every kernel count set to 0 just before it and read
    just after: asserts ``step_kind={kind} tb_fallback={fallback}`` in
    its log and finite dumps of ``shape``; returns (record, fields)."""
    import torch
    from fdtd3d_torch import cli
    out_dir = os.path.join(OUT_DIR, label)
    argv = argv + ["--save-res", str(steps), "--check-finite",
                   "--save-dir", out_dir]
    captured = _io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(captured):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = ladder_launches()
    peak = torch.cuda.max_memory_allocated()
    log_txt = captured.getvalue()
    say(f"cli ({label}): " + " | ".join(log_txt.strip().splitlines()))
    if rc != 0:
        fail(f"{label}: cli.main returned {rc}")
    want = f"step_kind={kind}" + (f" tb_fallback={fallback}" if fallback
                                  else "")
    if want not in log_txt:
        fail(f"{label}: the CLI did not report {want}")
    done = [ln for ln in log_txt.splitlines() if ln.startswith("done: ")]
    mcps = float(done[0].split("(")[1].split()[0]) if done else None
    return {"steps": steps, "kind": kind, "wall_s": wall,
            "launches": launches, "mcells_per_s": mcps,
            "peak_mem_bytes": peak}, load_dumps(out_dir, steps, shape,
                                                label)


def ladder_cli(label, argv, names, kind, cfg):
    """Phase 12: one CLI run (``run_cli``) under the ladder variables
    ``names``; its record gains the TFSF leakage of its dumps."""
    from fdtd3d_torch import diag
    from fdtd3d_torch.solver import build_static
    with ladder_env(*names):
        rec, fields = run_cli(f"ladder_{label}", argv, kind, None,
                              cfg.grid_shape, cfg.time_steps)
    st = build_static(cfg).tfsf_setup
    rec.update(env=list(names),
               tfsf_leakage=diag.tfsf_leakage(fields, st.lo, st.hi))
    return rec, fields


def rel_fields(got, want):
    """max over components of |got - want| / the family's max |want|."""
    import numpy as np
    scale = {fam: max(float(np.abs(want[c]).max()) for c in want
                      if c[0] == fam) for fam in "EH"}
    return max(float(np.abs(got[c].astype(np.float64) - want[c]).max())
               / scale[c[0]] for c in want)


def ladder_bytes(static, coeffs, state, kernel, fp=None):
    """Bytes a launch must move: each field, psi, J and K it reads once,
    each output written once. ``kernel``: e_family or h_family (its
    family's psi of every slab axis, its TFSF records' plane terms, its
    coefficient grids inside the box outside which they hold their
    background, as the kernels read them: ``grid_cells``) or fused_eh
    (both families, the record terms, every grid whole, though the pass
    reads them only inside that box).
    E and H at their storage width, everything else f32. ``fp``: the
    launch's prepared operands (a shard's), else ``pallas3d.prepare``'s.
    """
    import numpy as np
    import torch
    from fdtd3d_torch.ops import pallas3d, tfsf
    cells = static.grid_shape[0] * static.grid_shape[1] \
        * static.grid_shape[2]
    vol = 4 * cells
    fvol = next(iter(state["E"].values())).element_size() * cells
    fams = {"e_family": "E", "h_family": "H", "fused_eh": "EH"}[kernel]
    n = (6 + 3 * len(fams)) * fvol         # both families read, own written
    if fp is None:
        fp = pallas3d.prepare(static, coeffs)
    if fp["plan"] is not None:
        if kernel == "fused_eh":
            n += 4 * fp["plan"].total
        else:
            n += 4 * sum(int(np.prod(tfsf.plane_shape(fp["shape"], axis)))
                         for _, axis, _, _ in fp[f"rec_{fams}"])
    for fam in fams:
        psi = state["psi_E" if fam == "E" else "psi_H"] \
            if "psi_E" in state else {}
        n += sum(2 * v.numel() * 4 for v in psi.values())
        n += 2 * 3 * vol * (("J" if fam == "E" else "K") in state)
        fc = fp[fam]
        box = None if kernel == "fused_eh" else grid_cells(fc)
        for key in ("a", "b", "kj", "bj"):
            for v in fc[key] or []:
                if isinstance(v, torch.Tensor):
                    n += 4 * (v.numel() if box is None else box)
    return n


def ladder_ops(static, state, kernel):
    """Operations of a launch at the f32 peak's scale: per component two
    differences (sub, mul, add into the accumulator) and the update (2
    mul + 1 add), 7 per slab psi cell, 4 per Drude J or K cell, the
    fused pass both families; the ladder's kernels are built without
    FMA contraction, so the flops count at the non-FMA rate (x F32_FLOPS
    / F32_NONFMA_OPS)."""
    cells = static.grid_shape[0] * static.grid_shape[1] \
        * static.grid_shape[2]
    f = 0
    for fam in {"e_family": "E", "h_family": "H", "fused_eh": "EH"}[kernel]:
        f += 3 * cells * (2 * 3 + 3)
        psi = state["psi_E" if fam == "E" else "psi_H"] \
            if "psi_E" in state else {}
        f += sum(v.numel() * 7 for v in psi.values())
        if ("J" if fam == "E" else "K") in state:
            f += 3 * cells * 4
    return f * F32_FLOPS / F32_NONFMA_OPS


def ladder_times(cfg, dev, advance, reps, plain_reps, label):
    """Phase 13: on the state ``advance`` main-path steps into the run,
    each ladder kernel launch and each ladder step held against its
    plain version at the run's shape (the gate of ``compare``), then
    same-call CUDA-event times of each launch and its plain version
    beside its bound, and of the whole two-pass, fused, packed and
    temporal-blocked steps. Returns (times, worst absolute error per
    kernel)."""
    import torch
    from fdtd3d_torch.ops import packed, packed_tb, pallas3d, pallas_fused
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(cfg, device=dev)
    sim.advance(advance)
    static, coeffs = sim.static, sim.coeffs
    st = sim.state
    fargs = fused_args(static, coeffs, st)
    out = {"shape": list(static.grid_shape), "advance": advance}
    err = {}
    for name, fn, plain, args, outs in family_calls(static, coeffs, st) + (
            ("fused_eh", pallas_fused.fused_eh, pallas_fused.fused_eh_plain,
             fargs, FUSED_OUTS),):
        got = as_tree(fn(*args), outs)
        want = as_tree(plain(*args), outs)
        torch.cuda.synchronize()
        err[name] = compare(got, want, f"{label}: one {name} launch",
                            family=True)
        if name == "fused_eh":
            out["fused_section_err"] = fused_section_errors(fargs[5], got,
                                                            want)
            out["fused_occupancy"] = pallas_fused.occupancy()
            out["fused_plan_counts"] = list(pallas_fused.device_plan(
                fargs[5], dev)[1])
        else:
            out[f"{name}_section_err"] = family_sections_check(
                label, name, args, got, want)
            fam = name[0].upper()
            out[f"{name}_plan_counts"] = list(
                (args[4] if fam == "E" else args[3])[f"_plan_{fam}"][1][1])
        del got, want
        out[f"{name}_ms"] = timed(lambda: fn(*args), reps)
        if name != "fused_eh":
            out[f"{name}_launch_ms"] = family_launch_ms(name, args, reps)
        out[f"{name}_plain_ms"] = timed(lambda: plain(*args), plain_reps)
        nbytes = ladder_bytes(static, coeffs, st, name)
        out[f"{name}_bytes"] = nbytes
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = bound(
            nbytes, ladder_ops(static, st, name))
    for name, build_step in (("pallas3d", pallas3d.make_pallas_step),
                             ("fused", pallas_fused.make_fused_eh_step)):
        k_step = build_step(static, dev)
        p_step = build_step(static, dev, plain=True)
        cc = k_step.prepare(coeffs)
        got, want = k_step(st, cc), p_step(st, cc)
        torch.cuda.synchronize()
        key = "e_family" if name == "pallas3d" else "fused_eh"
        err[key] = max(err[key], compare(
            got, want, f"{label}: one {k_step.kind} step", family=True))
        del got, want
        out[f"{name}_step_ms"] = timed(lambda: k_step(st, cc), reps)
        out[f"{name}_plain_step_ms"] = timed(lambda: p_step(st, cc),
                                             plain_reps)
    carry = sim._carry
    pk = packed.make_packed_step(static, dev)
    pcc = pk.prepare(coeffs)
    out["packed_step_ms"] = timed(lambda: pk(carry, pcc), reps)
    tb = packed_tb.make_packed_tb_step(static, dev)
    tcc = tb.prepare(coeffs)
    out["tb_step_ms"] = timed(lambda: tb(carry, tcc), reps) / 2
    # the tb pass's kernel against two packed steps' kernels, same call
    spare = packed.alloc_like(carry)
    _, terms, drive = packed_tb.generation_terms(static, tcc["tb"],
                                                 carry.get("inc"),
                                                 carry["t"])
    out["tb_pass_ms"] = timed(lambda: packed_tb.tb_pass(
        carry, spare, tcc["tb"], terms, drive), reps)
    out["e_update_ms"] = timed(lambda: packed.e_update(
        carry["E"], carry["H"], carry.get("J"), carry["psE"], pcc["E"]),
        reps)
    out["h_update_ms"] = timed(lambda: packed.h_update(
        carry["H"], carry["E"], carry["psH"], pcc["H"]), reps)
    out["tb_report"] = tb_report(
        f"{label}, phase 13", out["tb_pass_ms"],
        bound(tb_bytes(carry, tcc), tb_flops(carry, tcc))[0],
        out["e_update_ms"] + out["h_update_ms"])
    del spare, terms
    cells = static.grid_shape[0] * static.grid_shape[1] \
        * static.grid_shape[2]
    for k in ("pallas3d", "fused", "packed", "tb"):
        out[f"{k}_mcells_per_s"] = cells / (out[f"{k}_step_ms"] * 1e-3) / 1e6
    out["fused_over_pallas3d_step"] = out["fused_step_ms"] \
        / out["pallas3d_step_ms"]
    say(f"ladder times ({label}): " + json.dumps(out))
    say(f"{label}: one launch and one step of each ladder kernel on the "
        f"run's state match the plain versions (max abs err "
        f"{json.dumps(err)})")
    del sim, st, carry
    torch.cuda.empty_cache()
    return out, err


# --------------------------------------------------------------------------
# bf16 storage with f32 compute (phases 14-19)
# --------------------------------------------------------------------------

def bf16_kernels_vs_plain(dev, mie128):
    """Phase 14: each bf16 kernel against its plain version: one launch
    at 256^3 from seeded fields (e_update, h_update, the tb pass,
    e_family, h_family, the fused call), then 10 steps at 128^3 with the
    eps and Drude spheres, a point source and the oblique wave (``mie128``
    flags); the reference's bf16 gates. Worst absolute error per
    kernel: (one launch at 256^3, the steps at 128^3)."""
    from fdtd3d_torch.ops import packed
    cfg = config(EXAMPLE, ["--same-size", "256"] + BF16)
    label = "bf16 256^3 TFSF+CPML"
    sim = seeded_sim(cfg, dev, 51)
    err = {"e_update": one_launch_vs_plain(sim, packed.e_update,
                                           packed.e_update_plain, "E",
                                           BF16_TOL),
           "h_update": one_launch_vs_plain(sim, packed.h_update,
                                           packed.h_update_plain, "H",
                                           BF16_TOL)}
    del sim
    err["tb_pass"] = tb_vs_plain(cfg, dev, 52, 1, label, TB_BF16_TOL)
    err.update(ladder_vs_plain(cfg, dev, 53, label, steps=1, tol=BF16_TOL))
    cfg = config(MIE, mie128 + BF16)
    label = "bf16 128^3 eps + Drude spheres, point source, oblique TFSF"
    pk = kernel_vs_plain(cfg, dev, 54, label, steps=STEPS_CMP, tol=BF16_TOL)
    steps = {"e_update": pk, "h_update": pk, "tb_pass": tb_vs_plain(
        cfg, dev, 55, STEPS_CMP // 2, label, TB_BF16_TOL)}
    steps.update(ladder_vs_plain(cfg, dev, 56, label, steps=STEPS_CMP,
                                 tol=BF16_TOL))
    return err, steps


def bf16_times(cfg32, cfg16, dev, advance, reps, plain_reps, label):
    """Phases 16 and 17: on the state ``advance`` steps into a run of
    each storage dtype (``cfg32``, ``cfg16``: one configuration in f32
    and in bf16), one launch of every bf16 kernel against its plain
    version (the reference's bf16 gates, of the family max), then
    same-call CUDA-event times of every kernel in f32 and in bf16 in
    turns and of the bf16 plain versions, each beside its bound at its
    storage width, and of the whole tb, packed, fused and two-pass steps
    in both dtypes. Returns (times, worst absolute error per bf16
    kernel)."""
    import torch
    from fdtd3d_torch.ops import packed, packed_tb, pallas3d, pallas_fused
    from fdtd3d_torch.sim import Simulation
    ops = {}
    for dt, cfg in (("f32", cfg32), ("bf16", cfg16)):
        sim = Simulation(cfg, device=dev)
        sim.advance(advance)
        static, coeffs, carry = sim.static, sim.coeffs, sim._carry
        o = {"sim": sim, "static": static, "carry": carry,
             "pk": packed.make_packed_step(static, dev),
             "tbs": packed_tb.make_packed_tb_step(static, dev),
             "steps": {}}
        o["pcc"] = o["pk"].prepare(coeffs)
        o["tcc"] = o["tbs"].prepare(coeffs)
        _, terms, drive = packed_tb.generation_terms(
            static, o["tcc"]["tb"], carry.get("inc"), carry["t"])
        o["st"] = st = sim.state
        spare = packed.alloc_like(carry)
        o["calls"] = {
            "tb_pass": (packed_tb.tb_pass, packed_tb.tb_pass_plain,
                        (carry, spare, o["tcc"]["tb"], terms, drive)),
            "e_update": (packed.e_update, packed.e_update_plain,
                         (carry["E"], carry["H"], carry.get("J"),
                          carry["psE"], o["pcc"]["E"])),
            "h_update": (packed.h_update, packed.h_update_plain,
                         (carry["H"], carry["E"], carry["psH"],
                          o["pcc"]["H"])),
            **{name: (fn, plain, args) for name, fn, plain, args, _ in
               family_calls(static, coeffs, st)},
            "fused_eh": (pallas_fused.fused_eh, pallas_fused.fused_eh_plain,
                         fused_args(static, coeffs, st))}
        for name, build_step in (("pallas3d", pallas3d.make_pallas_step),
                                 ("fused", pallas_fused.make_fused_eh_step)):
            k_step = build_step(static, dev)
            o["steps"][name] = (k_step, k_step.prepare(coeffs))
        ops[dt] = o
    # one launch of each bf16 kernel against its plain version
    o = ops["bf16"]
    err = {}
    for name, (fn, plain, args) in o["calls"].items():
        if name == "tb_pass":
            got, want = packed.alloc_like(o["carry"]), \
                packed.alloc_like(o["carry"])
            fn(args[0], got, *args[2:])
            plain(args[0], want, *args[2:])
            tol = TB_BF16_TOL
        elif name in ("e_update", "h_update"):
            got, want = clone_carry(o["carry"]), clone_carry(o["carry"])
            for tree, f in ((got, fn), (want, plain)):
                if name == "e_update":
                    f(tree["E"], tree["H"], tree.get("J"), tree["psE"],
                      args[4])
                else:
                    f(tree["H"], tree["E"], tree["psH"], args[3])
            got, want = pass_fields(got), pass_fields(want)
            tol = BF16_TOL
        else:
            outs = dict(FAMILY_OUTS, fused_eh=FUSED_OUTS)[name]
            got = as_tree(fn(*args), outs)
            want = as_tree(plain(*args), outs)
            tol = BF16_TOL
        torch.cuda.synchronize()
        err[name] = compare(got, want, f"{label}: one bf16 {name} launch",
                            family=True, tol=tol)
        if name in FAMILY_OUTS:
            family_sections_check(f"{label} bf16", name, args, got, want)
        del got, want
    # times, f32 and bf16 in turns
    cells = 1
    for n in o["static"].grid_shape:
        cells *= n
    out = {"shape": list(o["static"].grid_shape), "advance": advance}
    for name in o["calls"]:
        for dt in ("f32", "bf16"):
            fn, plain, args = ops[dt]["calls"][name]
            out[f"{name}_{dt}_ms"] = timed(lambda: fn(*args), reps)
            if name in FAMILY_OUTS:
                out[f"{name}_{dt}_launch_ms"] = family_launch_ms(
                    name, args, reps)
        fn, plain, args = o["calls"][name]
        out[f"{name}_bf16_plain_ms"] = timed(lambda: plain(*args),
                                             plain_reps)
        for dt in ("f32", "bf16"):
            d = ops[dt]
            if name == "tb_pass":
                nbytes = tb_bytes(d["carry"], d["tcc"])
                flops = tb_flops(d["carry"], d["tcc"])
            elif name in ("e_update", "h_update"):
                fam = name[0].upper()
                nbytes = family_bytes(d["carry"], d["pcc"], fam)
                flops = family_flops(d["carry"], fam)
            else:
                nbytes = ladder_bytes(d["static"], d["sim"].coeffs, d["st"],
                                      name)
                flops = ladder_ops(d["static"], d["st"], name)
            out[f"{name}_{dt}_bytes"] = nbytes
            out[f"{name}_{dt}_bound_ms"], out[f"{name}_{dt}_bound_by"] = \
                bound(nbytes, flops)
        out[f"{name}_bf16_over_f32"] = out[f"{name}_bf16_ms"] \
            / out[f"{name}_f32_ms"]
    for dt in ("f32", "bf16"):
        d = ops[dt]
        out[f"tb_step_{dt}_ms"] = timed(
            lambda: d["tbs"](d["carry"], d["tcc"]), reps) / 2
        out[f"packed_step_{dt}_ms"] = timed(
            lambda: d["pk"](d["carry"], d["pcc"]), reps)
        for name, (k_step, cc) in d["steps"].items():
            out[f"{name}_step_{dt}_ms"] = timed(
                lambda: k_step(d["st"], cc), reps)
        for k in ("tb", "packed", "pallas3d", "fused"):
            out[f"{k}_{dt}_mcells_per_s"] = cells / (
                out[f"{k}_step_{dt}_ms"] * 1e-3) / 1e6
    if o["static"].grid_shape == (256, 256, 256):
        from fdtd3d_torch.ops import packed_tb as _tb
        out["occupancy"] = {
            "tb": {k: [v["registers"], v["local_bytes"], v["blocks_per_sm"]]
                   for k, v in _tb.occupancy().items() if "lanes" not in k},
            "fused": {k: [v["registers"], v["local_bytes"],
                          v["blocks_per_sm"]]
                      for k, v in pallas_fused.occupancy().items()}}
    out["family"] = {dt: family_report(f"{label}, {dt}", out, f"_{dt}")
                     for dt in ("f32", "bf16")}
    say(f"bf16 vs f32 times ({label}): " + json.dumps(out))
    say(f"{label}: one launch of each bf16 kernel on the run's state "
        f"matches its plain version (max abs err {json.dumps(err)})")
    del ops, o, d
    torch.cuda.empty_cache()
    return out, err


def bf16_main_paths(cfg256, steps, f32_fields):
    """Phase 15: the bf16 main path through the CLI (150 steps: the tb
    pass alone; 151: and the packed tail), its dumps within BF16_TRACK of
    the family max of the f32 main path's dumps (``f32_fields``); the
    TFSF leakage is printed (bf16 storage floors it at its rounding)."""
    runs = {n: cli_main_path(n, cfg256, "bfloat16")
            for n in (steps, steps + 1)}
    for n, want in ((steps, {"tb_pass": steps // 2, "e_update": 0,
                             "h_update": 0}),
                    (steps + 1, {"tb_pass": steps // 2, "e_update": 1,
                                 "h_update": 1})):
        if runs[n]["launches"] != want:
            fail(f"bf16 main path, {n} steps: kernel launches "
                 f"{runs[n]['launches']} != {want}")
    rel = rel_fields(runs[steps].pop("fields"), f32_fields)
    runs[steps + 1].pop("fields")
    runs[steps]["rel_vs_f32"] = rel
    say(f"bf16 main path: dumps within {rel:.3e} of the f32 run's family "
        f"max (gate {BF16_TRACK}); TFSF leakage "
        f"{runs[steps]['tfsf_leakage']:.3e} (f32 "
        f"{REF_LEAKAGE:.3e} in the reference at 48^3)")
    if not rel < BF16_TRACK:
        fail(f"the bf16 main path's dumps are {rel:.3e} of the family max "
             f"away from the f32 run's (gate {BF16_TRACK})")
    return runs


def bf16_ladder_cli(cfg256, f32_fields, dev):
    """Phase 17 (CLI): vacuum3D_tfsf at 256^3 in bf16 under
    FDTD3D_NO_PACKED with FDTD3D_NO_FUSED and with FDTD3D_FORCE_FUSED:
    the kind, one launch a family a step (two-pass) or one call a step
    (fused) and no main-path kernel, finite dumps within BF16_TRACK of
    the f32 main path's; the fused vs two-pass rel and the leakage are
    printed."""
    from fdtd3d_torch.solver import build_static
    runs, fields = {}, {}
    n = cfg256.time_steps
    sections = fused_sections_per_step(build_static(cfg256), dev)
    family_sections = family_sections_per_step(build_static(config(
        EXAMPLE, ["--same-size", "256"] + BF16)), dev)
    for kind, names in (("pallas3d_cuda", ("FDTD3D_NO_PACKED",
                                           "FDTD3D_NO_FUSED")),
                        ("fused_cuda", ("FDTD3D_NO_PACKED",
                                        "FDTD3D_FORCE_FUSED"))):
        rec, fields[kind] = ladder_cli(
            f"bf16_vacuum256_{kind}", ["--cmd-from-file", EXAMPLE,
                                       "--same-size", "256"] + BF16,
            names, kind, cfg256)
        two = kind == "pallas3d_cuda"
        want = {"e_family": n if two else 0, "h_family": n if two else 0,
                "family_kernels": n * family_sections if two else 0,
                "fused_eh": 0 if two else n,
                "fused_eh_kernels": 0 if two else n * sections,
                "tb_pass": 0, "e_update": 0, "h_update": 0}
        if rec["launches"] != want:
            fail(f"bf16 ladder {kind}: launches {rec['launches']} != "
                 f"{want}")
        rec["rel_vs_f32"] = rel_fields(fields[kind], f32_fields)
        if not rec["rel_vs_f32"] < BF16_TRACK:
            fail(f"bf16 ladder {kind}: dumps {rec['rel_vs_f32']:.3e} of "
                 f"the family max from the f32 main path's")
        runs[kind] = rec
        say(f"bf16 ladder main path {kind}: {json.dumps(rec)}")
        shutil.rmtree(os.path.join(OUT_DIR, f"ladder_bf16_vacuum256_{kind}"),
                      ignore_errors=True)
    runs["fused_vs_pallas3d_rel"] = rel_fields(fields["fused_cuda"],
                                               fields["pallas3d_cuda"])
    say(f"bf16 ladder: fused vs two-pass dumps, rel "
        f"{runs['fused_vs_pallas3d_rel']:.3e} of the family max")
    return runs


def capacity_run(size, dtype, steps, dev):
    """Phase 19: vacuum3D_tfsf at ``size``^3 through ``Simulation`` in
    ``dtype``: set-up seconds, Mcells/s over ``steps`` steps after two
    warm-up steps, finite fields, and peak device memory."""
    import torch
    from fdtd3d_torch.sim import Simulation
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    cfg = config(EXAMPLE, ["--same-size", str(size), "--dtype", dtype,
                           "--check-finite"])
    sim = Simulation(cfg, device=dev)
    sim.advance(2)
    torch.cuda.synchronize()
    setup = time.time() - t0
    t0 = time.time()
    sim.advance(steps)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(v).all())
                 for v in sim.component_views().values())
    rec = {"size": size, "dtype": dtype, "step_kind": sim.step_kind,
           "steps": steps, "setup_s": setup, "wall_s": wall,
           "mcells_per_s": size ** 3 * steps / wall / 1e6,
           "peak_mem_bytes": peak, "finite": finite}
    del sim
    torch.cuda.empty_cache()
    say(f"capacity: {json.dumps(rec)}")
    if not finite or rec["step_kind"] != "packed_tb_cuda":
        fail(f"capacity run at {size}^3 {dtype}: {rec}")
    return rec



# --------------------------------------------------------------------------
# compensated (Kahan) float32 and magnetic Drude K (phases 20-24)
# --------------------------------------------------------------------------

COMPENSATED = os.path.join(ROOT, "Examples", "precision3D_compensated.txt")
C0 = 299792458.0
# Examples/metamaterial1D_dng.txt's plasma frequency over its source's
# (1.507e11 rad/s at 15e-3 m: ~1.2), at sphere3D_mie.txt's 60e-3 m
DNG_OMEGA_P = 1.507e11 / (2 * 3.141592653589793 * C0 / 15e-3) \
    * (2 * 3.141592653589793 * C0 / 60e-3)
CAVITY_FACTOR, CAVITY_BAR = 0.9, 2.5e-6   # tests/test_compensated.py:124


def dng_flags(size, steps, omega_pm=DNG_OMEGA_P):
    """sphere3D_mie.txt at ``size`` for ``steps`` steps with electric and
    magnetic Drude on its sphere (centre size/2, radius size/8; the
    file's own at 512): a double-negative sphere, omega_p = omega_pm =
    ``DNG_OMEGA_P``, lossless."""
    c, r = str(size // 2), str(size // 8)
    out = ["--same-size", str(size), "--time-steps", str(steps)]
    for sph in ("eps-sphere", "drude-sphere", "drude-m-sphere"):
        for a in "xyz":
            out += [f"--{sph}-center-{a}", c]
        out += [f"--{sph}-radius", r]
    return out + ["--use-drude", "--omega-p", repr(DNG_OMEGA_P),
                  "--use-drude-m", "--omega-pm", repr(omega_pm)]


def compensated_kernels(cfg, dev, seed, label, steps):
    """One e_update and one h_update launch of the compensated build
    against their plain versions on a seeded carry (E, H, rE, rH), then
    ``steps`` packed steps of kernels against plain versions: bit for
    bit (max |diff| 0.0: the variant runs the plain version's operations
    in its order, none contracted). Returns the worst absolute error."""
    from fdtd3d_torch.ops import packed
    sim = seeded_sim(cfg, dev, seed)
    if sim.step_kind != "packed_cuda":
        fail(f"{label}: ran {sim.step_kind}, not packed_cuda")
    errs = [one_launch_vs_plain(sim, packed.e_update,
                                packed.e_update_plain, "E"),
            one_launch_vs_plain(sim, packed.h_update,
                                packed.h_update_plain, "H")]
    del sim
    errs.append(kernel_vs_plain(cfg, dev, seed, label, steps))
    if any(errs):
        fail(f"{label}: the compensated launches differ from their plain "
             f"versions (max |diff| of one E, one H launch, {steps} steps: "
             f"{errs})")
    return max(errs)


def compensated_example(dev, size=256):
    """Phase 20 (C1): the compensated kernels against their plain
    versions at the example's 64^3 and at 256^3, then
    Examples/precision3D_compensated.txt as it stands through the CLI
    (64^3, 150 steps, point source, CPML 8; a dump at step 150): the
    packed CUDA step with tb_fallback compensated, 150 launches of each
    family and no other kernel, finite dumps; the dumps' error against
    the port's float64 plain step and the plain f32 run of the same
    file (rel: max over components of |x - y| / the family's max |y|)."""
    from fdtd3d_torch.sim import Simulation
    out = {"max_abs_err": {
        "64": compensated_kernels(config(COMPENSATED, []), dev, 61,
                                  "compensated 64^3", STEPS_CMP),
        str(size): compensated_kernels(
            config(EXAMPLE, ["--same-size", str(size), "--compensated"]),
            dev, 62, f"compensated {size}^3 TFSF+CPML", 2)}}
    rec, fields = run_cli("compensated_example", ["--cmd-from-file",
                                                  COMPENSATED],
                          "packed_cuda", "compensated", (64, 64, 64), 150)
    n = rec["launches"]
    if n["e_update"] != 150 or n["h_update"] != 150 or any(
            n[k] for k in n if k not in ("e_update", "h_update")):
        fail(f"compensated example: launches {n}, not 150 of each family "
             f"alone")
    out["cli"] = rec
    refs = {}
    for key, extra in (("float64", ["--no-compensated", "--dtype",
                                    "float64"]),
                       ("float32", ["--no-compensated"])):
        sim = Simulation(config(COMPENSATED, extra), device=dev).run()
        refs[key] = {c: v.astype("float64") for c, v in
                     sim.fields().items()}
        out[f"{key}_kind"] = sim.step_kind
        del sim
    out["rel_vs_float64"] = rel_fields(fields, refs["float64"])
    out["rel_vs_float32"] = rel_fields(fields, refs["float32"])
    out["float32_rel_vs_float64"] = rel_fields(refs["float32"],
                                               refs["float64"])
    say("compensated example: " + json.dumps(out))
    return out


def compensated_times(dev, reps, plain_reps, size=256):
    """Phase 21 (C2): Examples/vacuum3D_tfsf.txt at 256^3 for 150 steps
    with --compensated and without, through the CLI in one call (the
    compensated packed step against the f32 main path), then, 150 steps
    into a compensated run and a packed f32 run, CUDA-event times of the
    compensated e_update/h_update and of the f32 builds in turns, their
    plain versions, the bounds (the byte counters with the bf16
    residuals; operations at the non-FMA rate for the compensated
    build) and the whole packed steps."""
    import torch
    from fdtd3d_torch.ops import packed
    from fdtd3d_torch.sim import Simulation
    out = {}
    argv = ["--cmd-from-file", EXAMPLE, "--same-size", str(size)]
    shape = (size,) * 3
    out["cli_compensated"], _ = run_cli(
        "c2_compensated", argv + ["--compensated"], "packed_cuda",
        "compensated", shape, 150)
    out["cli_f32"], _ = run_cli("c2_f32", argv, "packed_tb_cuda", None,
                                shape, 150)
    if out["cli_compensated"]["launches"]["e_update"] != 150:
        fail(f"C2: {out['cli_compensated']['launches']}")
    runs = {}
    for key, extra in (("comp", ["--compensated"]), ("f32", [])):
        os.environ["FDTD3D_NO_TEMPORAL"] = "1"   # the packed f32 step
        try:
            sim = Simulation(config(EXAMPLE, ["--same-size", str(size)]
                                    + extra), device=dev)
        finally:
            os.environ.pop("FDTD3D_NO_TEMPORAL")
        if sim.step_kind != "packed_cuda":
            fail(f"C2 {key}: ran {sim.step_kind}")
        sim.advance(150)
        carry = sim._carry
        step = packed.make_packed_step(sim.static, dev)
        cc = step.prepare(sim.coeffs)
        runs[key] = (sim, carry, step, cc)
    for turn in range(2):
        for key in (("comp", "f32") if turn == 0 else ("f32", "comp")):
            sim, carry, step, cc = runs[key]
            out.setdefault(f"e_update_{key}_ms", []).append(timed(
                lambda: packed.e_update(carry["E"], carry["H"], None,
                                        carry["psE"], cc["E"],
                                        carry.get("rE")), reps))
            out.setdefault(f"h_update_{key}_ms", []).append(timed(
                lambda: packed.h_update(carry["H"], carry["E"],
                                        carry["psH"], cc["H"], None,
                                        carry.get("rH")), reps))
    for key in ("comp", "f32"):
        sim, carry, step, cc = runs[key]
        for fam in ("e", "h"):
            ms = out[f"{fam}_update_{key}_ms"]
            out[f"{fam}_update_{key}_ms"] = sum(ms) / len(ms)
            out[f"{fam}_update_{key}_ms_turns"] = ms
            F = fam.upper()
            nbytes = family_bytes(carry, cc, F)
            flops = family_flops(carry, F)
            if key == "comp":     # explicitly rounded: the non-FMA rate
                flops = flops * F32_FLOPS / F32_NONFMA_OPS
            out[f"{fam}_update_{key}_bytes"] = nbytes
            out[f"{fam}_update_{key}_bytes_per_cell"] = nbytes / size ** 3
            out[f"{fam}_update_{key}_bound_ms"], \
                out[f"{fam}_update_{key}_bound_by"] = bound(nbytes, flops)
        out[f"packed_step_{key}_ms"] = timed(lambda: step(carry, cc), reps)
    sim, carry, step, cc = runs["comp"]
    out["e_update_comp_plain_ms"] = timed(lambda: packed.e_update_plain(
        carry["E"], carry["H"], None, carry["psE"], cc["E"], carry["rE"]),
        plain_reps)
    out["h_update_comp_plain_ms"] = timed(lambda: packed.h_update_plain(
        carry["H"], carry["E"], carry["psH"], cc["H"], None, carry["rH"]),
        plain_reps)
    out["launches_a_step"] = {"e_update": 1, "h_update": 1}
    say(f"compensated times ({size}^3): " + json.dumps(out))
    del runs, sim, carry, step, cc
    torch.cuda.empty_cache()
    return out


def cavity_check(dev):
    """Phase 22 (C3): tests/test_compensated.py:87 on the card: the (2,
    3, 1) eigenmode of a 17^3 PEC cavity for 1000 steps, the worst
    component's error against fdtd3d_torch/exact.py over its mode's max;
    compensated through the packed CUDA kernel, f32 through the plain
    step (the twin of the reference's jnp step, whose error its gate
    takes) and through the f32 main path's kernel (reported). Gates:
    e32c < 0.9 e32 and e32c < 2.5e-6."""
    import numpy as np
    from fdtd3d_torch import exact
    from fdtd3d_torch.config import PmlConfig, SimConfig
    from fdtd3d_torch.sim import Simulation
    out = {}
    for key, comp, flag in (("e32c", True, None), ("e32", False, False),
                            ("e32_main_path", False, None)):
        cfg = SimConfig(scheme="3D", size=(17, 17, 17), time_steps=1000,
                        dx=1e-3, courant_factor=0.5, wavelength=8e-3,
                        pml=PmlConfig(size=(0, 0, 0)), compensated=comp,
                        use_pallas=flag)
        sim = Simulation(cfg, device=dev)
        shapes, omega = exact.cavity_mode((17, 17, 17), (2, 3, 1), cfg.dx,
                                          cfg.dt)
        for c, v in shapes.items():
            sim.set_field(c, v.astype(np.float32))
        sim.run()
        out[key] = max(
            float(np.abs(np.asarray(sim.field(c), np.float64)
                         - exact.cavity_expectation(s, omega, cfg.dt, 1000)
                         ).max() / np.abs(s).max())
            for c, s in shapes.items())
        out[f"{key}_kind"] = sim.step_kind
    if out["e32c_kind"] != "packed_cuda":
        fail(f"C3: the compensated cavity ran {out['e32c_kind']}")
    if not (out["e32c"] < CAVITY_FACTOR * out["e32"]
            and out["e32c"] < CAVITY_BAR):
        fail(f"C3: the cavity gate failed: e32c {out['e32c']:.4e}, e32 "
             f"{out['e32']:.4e} (needs e32c < {CAVITY_FACTOR} e32 and < "
             f"{CAVITY_BAR})")
    say("cavity gate: " + json.dumps(out))
    return out


def drude_m_kernels_vs_plain(sim, dev, label, tol, steps):
    """On a run's packed carry: one e_update and one h_update launch (J,
    K) against their plain versions, then ``steps`` packed steps of
    kernels against plain versions, at ``tol`` of each family's max.
    Returns the worst absolute error."""
    import torch
    from fdtd3d_torch.ops import packed
    err = max(one_launch_vs_plain(sim, packed.e_update,
                                  packed.e_update_plain, "E", tol),
              one_launch_vs_plain(sim, packed.h_update,
                                  packed.h_update_plain, "H", tol))
    k_step = packed.make_packed_step(sim.static, dev)
    p_step = packed.make_packed_step(sim.static, dev, plain=True)
    cc = k_step.prepare(sim.coeffs)
    ck, cp = clone_carry(sim._carry), clone_carry(sim._carry)
    for _ in range(steps):
        ck = k_step(ck, cc)
        cp = p_step(cp, cc)
    torch.cuda.synchronize()
    err = max(err, compare(ck, cp, f"{label}: {steps} packed steps",
                           family=True, tol=tol))
    del ck, cp
    torch.cuda.empty_cache()
    return err


def dng_mie(dev, dtype, steps, reps, plain_reps, size=512):
    """Phase 23 (C4): the double-negative sphere (``dng_flags``) in
    sphere3D_mie.txt at 512^3 through ``Simulation`` for ``steps``
    steps with the finite check: the packed CUDA step (tb_fallback
    magnetic_drude), one launch of each family a step, set-up seconds,
    ms a step, Mcells/s and peak memory; then, on the run's state, one
    launch of each family and 8 packed steps against the plain versions
    (2e-6 f32, 2e-2 bf16 of each family's max) and CUDA-event times of
    e_update and h_update (J and K) beside their plain versions and
    bounds."""
    import torch
    from fdtd3d_torch.ops import packed
    from fdtd3d_torch.sim import Simulation
    label = f"DNG sphere {size}^3 {dtype}"
    cfg = config(MIE, dng_flags(size, steps) + ["--dtype", dtype,
                                                 "--check-finite"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sim = Simulation(cfg, device=dev)
    setup = time.time() - t0
    if sim.step_kind != "packed_cuda" or sim.step_diag.get(
            "tb_fallback") != {"reason": "magnetic_drude"}:
        fail(f"{label}: ran {sim.step_kind} {sim.step_diag}")
    reset_launches()
    torch.cuda.synchronize()
    t1 = time.time()
    sim.run()
    torch.cuda.synchronize()
    wall = time.time() - t1
    launches = ladder_launches()
    peak = torch.cuda.max_memory_allocated()
    if launches["e_update"] != steps or launches["h_update"] != steps \
            or launches["tb_pass"] or launches["fused_eh"] \
            or launches["e_family"]:
        fail(f"{label}: launches {launches}")
    if not all(bool(torch.isfinite(v.float()).all())
               for _, v in leaves(sim._carry)):
        fail(f"{label}: non-finite state after {steps} steps")
    tol = TOL if dtype == "float32" else BF16_TOL
    err = drude_m_kernels_vs_plain(sim, dev, label, tol, 8)
    carry = sim._carry
    cc = packed.make_packed_step(sim.static, dev).prepare(sim.coeffs)
    out = {"dtype": dtype, "steps": steps, "setup_s": setup,
           "step_ms": wall / steps * 1e3,
           "mcells_per_s": size ** 3 * steps / wall / 1e6,
           "peak_mem_bytes": peak, "launches": launches,
           "max_abs_err": err, "omega_p": DNG_OMEGA_P}
    for fam, fn, plain, args in (
            ("E", packed.e_update, packed.e_update_plain,
             (carry["E"], carry["H"], carry["J"], carry["psE"], cc["E"])),
            ("H", packed.h_update, packed.h_update_plain,
             (carry["H"], carry["E"], carry["psH"], cc["H"], carry["K"]))):
        key = fam.lower()
        out[f"{key}_update_ms"] = timed(lambda: fn(*args), reps)
        out[f"{key}_plain_ms"] = timed(lambda: plain(*args), plain_reps)
        nbytes = family_bytes(carry, cc, fam)
        out[f"{key}_bytes"] = nbytes
        out[f"{key}_bound_ms"], out[f"{key}_bound_by"] = bound(
            nbytes, family_flops(carry, fam))
        whole = family_bytes(carry, cc, fam, whole_grids=True)
        out[f"{key}_bytes_whole_grids"] = whole
        out[f"{key}_bound_whole_grids_ms"] = bound(
            whole, family_flops(carry, fam))[0]
    say(f"{label}: " + json.dumps(out))
    del sim, carry, cc
    torch.cuda.empty_cache()
    return out


def dng_ladder(dev, steps, reps, plain_reps, size=256):
    """Phase 24 (C5): the double-negative sphere at 256^3 down the
    ladder, in f32 and bf16: one launch of e_family, h_family (K) and one
    fused_eh call (K in its H half) and 8 steps of each ladder step
    against their plain versions (the fused call and steps bit for bit,
    the two-pass ones at 2e-6 / 2e-2 of each family's max), the CLI
    under FDTD3D_FORCE_FUSED and under FDTD3D_NO_PACKED + FDTD3D_NO_FUSED
    (one fused call a step, or one launch of each family a step, and no
    other kernel; finite dumps), and, on the run's state, CUDA-event
    times of each ladder launch and its plain version beside its
    bound."""
    import torch
    from fdtd3d_torch.ops import pallas3d, pallas_fused
    from fdtd3d_torch.sim import Simulation
    from fdtd3d_torch.solver import build_static
    out, err = {}, {}
    for dtype in ("float32", "bfloat16"):
        tol = TOL if dtype == "float32" else BF16_TOL
        flags = dng_flags(size, steps) + ["--dtype", dtype]
        cfg = config(MIE, flags)
        label = f"DNG sphere {size}^3 {dtype}"
        e = ladder_vs_plain(cfg, dev, 71, label, steps=8, tol=tol)
        if e["fused_eh"] != 0.0:
            fail(f"{label}: the fused pass with K is not bit-equal to its "
                 f"plain version ({e['fused_eh']:.3e})")
        err[dtype] = e
        for names, kind, key in (
                (("FDTD3D_FORCE_FUSED",), "fused_cuda", "fused"),
                (("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"), "pallas3d_cuda",
                 "pallas3d")):
            with ladder_env(*names):
                rec, _ = run_cli(f"c5_{key}_{dtype}",
                                 ["--cmd-from-file", MIE] + flags, kind,
                                 "magnetic_drude", (size,) * 3, steps)
            n = rec["launches"]
            two = 0 if key == "fused" else steps
            want = {"fused_eh": steps - two, "e_family": two,
                    "h_family": two, "family_kernels":
                        two * family_sections_per_step(build_static(cfg),
                                                       dev),
                    "tb_pass": 0, "e_update": 0, "h_update": 0}
            if any(n[k] != v for k, v in want.items()):
                fail(f"{label} {kind}: launches {n}, want {want}")
            out[f"cli_{key}_{dtype}"] = rec
        sim = Simulation(cfg, device=dev)
        sim.advance(steps)
        static, coeffs, st = sim.static, sim.coeffs, sim.state
        for name, fn, plain, args, _ in family_calls(static, coeffs, st) + (
                ("fused_eh", pallas_fused.fused_eh,
                 pallas_fused.fused_eh_plain,
                 fused_args(static, coeffs, st), None),):
            k = f"{name}_{dtype}"
            out[f"{k}_ms"] = timed(lambda: fn(*args), reps)
            if name != "fused_eh":
                out[f"{k}_launch_ms"] = family_launch_ms(name, args, reps)
            out[f"{k}_plain_ms"] = timed(lambda: plain(*args), plain_reps)
            nbytes = ladder_bytes(static, coeffs, st, name)
            flops = ladder_ops(static, st, name)
            out[f"{k}_bytes"] = nbytes
            out[f"{k}_bound_ms"], out[f"{k}_bound_by"] = bound(nbytes,
                                                               flops)
        for name, build_step in (("pallas3d", pallas3d.make_pallas_step),
                                 ("fused", pallas_fused.make_fused_eh_step)):
            k_step = build_step(static, dev)
            cc = k_step.prepare(coeffs)
            out[f"{name}_step_{dtype}_ms"] = timed(lambda: k_step(st, cc),
                                                   reps)
        out[f"family_{dtype}"] = family_report(
            f"DNG sphere {size}^3 {dtype}", out, f"_{dtype}")
        del sim, st
        torch.cuda.empty_cache()
    say(f"DNG ladder ({size}^3): " + json.dumps(out))
    return out, err


def drude_m_lanes(dev, size=128):
    """Phase 24 (C5), lanes: 3 lanes at 128^3 of the double-negative
    sphere (``dng_flags``) with different omega_pm (per-lane bm and
    da/db grids) and point-source amplitudes: the batch authority admits
    them (the reference's carries K lanes on its packed kernel), the
    lane-capable packed step against its plain version, and each lane
    of one e_update + h_update launch against the same kernels run
    solo, bit for bit."""
    import torch
    from fdtd3d_torch.batch import BatchSimulation
    from fdtd3d_torch.ops import packed
    cfgs = [config(MIE, dng_flags(size, 8, DNG_OMEGA_P * f)
                   + ["--point-source", "Ez", "--point-source-x",
                      str(size // 3),
                      "--point-source-amplitude", str(a)])
            for f, a in ((1.0, 1.0), (0.8, 2.0), (1.2, 0.5))]
    bsim = BatchSimulation(cfgs, device=dev)
    if bsim.step_kind != "packed_cuda" or bsim.batch_fallback:
        fail(f"K lanes: ran {bsim.step_kind} {bsim.batch_fallback or ''}")
    seed_leaves(bsim._carry, dev, 81)
    static, B = bsim.static, bsim.batch_size
    carry = bsim._carry
    k_pk = packed.make_packed_step(static, dev, batch=B)
    p_pk = packed.make_packed_step(static, dev, plain=True, batch=B)
    pcc = k_pk.prepare(bsim._coeffs)
    ck, cp = clone_carry(carry), clone_carry(carry)
    k_pk(ck, pcc)
    p_pk(cp, pcc)
    torch.cuda.synchronize()
    err = compare(ck, cp, "K lanes: one lane-capable packed step",
                  family=True)
    del ck, cp
    for fc_lane in (None,) + tuple(range(B)):
        if fc_lane is None:
            a = clone_carry(carry)
            fe, fh = pcc["E"], pcc["H"]
        else:
            a = solo_lane(carry, fc_lane)
            fe = packed.lane_fc(pcc["E"], fc_lane)
            fh = packed.lane_fc(pcc["H"], fc_lane)
        packed.e_update(a["E"], a["H"], a["J"], a["psE"], fe)
        packed.h_update(a["H"], a["E"], a["psH"], fh, a["K"])
        torch.cuda.synchronize()
        a = {k: a[k] for k in ("E", "H", "J", "K", "psE", "psH")}
        if fc_lane is None:
            batched = a
        else:
            assert_lanes_equal(batched, fc_lane, a,
                               "K lanes: e_update + h_update")
    say(f"K lanes: the lane-capable packed step matches its plain version "
        f"({err:.3e}); every lane equals the same kernels run solo, bit "
        f"for bit")
    out = {"lanes": B, "max_abs_err": err}
    out.update(lane_update_times(bsim, pcc, 20, 2))
    out["main_path"] = lane_main_path(cfgs, "K lanes", 8, dev)
    say("K lanes: " + json.dumps(out))
    del bsim, carry
    torch.cuda.empty_cache()
    return out


def lane_update_times(bsim, pcc, reps, plain_reps):
    """CUDA-event times of one lane-capable e_update and h_update launch
    on ``bsim``'s carry (every lane), their plain versions and their
    bound: all lanes' bytes (B times a solo launch's), operations at the
    non-FMA rate for the compensated build."""
    from fdtd3d_torch.ops import packed
    carry = bsim._carry
    comp = "rE" in carry
    out = {}
    for fam, fn, plain, args in (
            ("E", packed.e_update, packed.e_update_plain,
             (carry["E"], carry["H"], carry.get("J"), carry["psE"], pcc["E"],
              carry.get("rE"))),
            ("H", packed.h_update, packed.h_update_plain,
             (carry["H"], carry["E"], carry["psH"], pcc["H"], carry.get("K"),
              carry.get("rH")))):
        key = fam.lower()
        out[f"{key}_update_ms"] = timed(lambda: fn(*args), reps)
        out[f"{key}_plain_ms"] = timed(lambda: plain(*args), plain_reps)
        nbytes = family_bytes(carry, pcc, fam)
        flops = family_flops(carry, fam)
        if comp:              # explicitly rounded: the non-FMA rate
            flops = flops * F32_FLOPS / F32_NONFMA_OPS
        out[f"{key}_bytes"] = nbytes
        out[f"{key}_bound_ms"], out[f"{key}_bound_by"] = bound(nbytes, flops)
    return out


def lane_main_path(cfgs, label, steps, dev):
    """The lanes through ``Simulation.run_batch`` for ``steps`` steps
    (the lane-capable packed step: one launch of each family a step, no
    other kernel), the kernel counts set to 0 just before and read just
    after, every lane healthy."""
    import torch
    from fdtd3d_torch.sim import Simulation
    reset_launches()
    bsim = Simulation.run_batch(cfgs, time_steps=steps, device=dev)
    torch.cuda.synchronize()
    n = ladder_launches()
    want = {k: (steps if k in ("e_update", "h_update") else 0) for k in n}
    if bsim.step_kind != "packed_cuda" or bsim.batch_fallback \
            or n != want or bsim.lane_finite != [True] * len(cfgs):
        fail(f"{label}: run_batch ran {bsim.step_kind} "
             f"{bsim.batch_fallback or ''} launches {n} lanes "
             f"{bsim.lane_finite}")
    return {"steps": steps, "launches": n}


def compensated_lanes(dev, size=128, times=True):
    """Phase 25 (C6): 3 compensated lanes at 128^3 (the compensated
    example's point source and CPML at 128^3; scalar coefficients shared
    by every lane), every carry leaf of each lane seeded from its own
    seed, the residuals included: one lane-capable compensated e_update
    + h_update launch and one lane-capable packed step against their
    plain versions, and each lane of one e_update + h_update launch
    against the same kernels run solo on that lane, all bit for bit;
    then (``times``) the launches' times beside their bound and the
    lanes through ``run_batch`` for 8 steps."""
    import torch
    from fdtd3d_torch.batch import BatchSimulation
    from fdtd3d_torch.ops import packed
    c = str(size // 2)
    cfgs = [config(COMPENSATED, ["--same-size", str(size),
                                 "--point-source-x", c, "--point-source-y",
                                 c, "--point-source-z", c,
                                 "--point-source-amplitude", amp])
            for amp in ("1.0", "2.0", "0.5")]
    bsim = BatchSimulation(cfgs, device=dev)
    if bsim.step_kind != "packed_cuda" or bsim.batch_fallback:
        fail(f"compensated lanes: ran {bsim.step_kind} "
             f"{bsim.batch_fallback or ''}")
    static, B = bsim.static, bsim.batch_size
    carry = bsim._carry
    for lane in range(B):
        g = torch.Generator(device=dev).manual_seed(91 + lane)
        for name, v in leaves(carry):
            if v.dim() == 0 or v.shape[0] != B:
                continue
            scale = 1e-10 if name in ("rE", "rH") else 0.01
            v[lane].copy_(scale * torch.randn(v[lane].shape, generator=g,
                                              device=dev))
    k_pk = packed.make_packed_step(static, dev, batch=B)
    p_pk = packed.make_packed_step(static, dev, plain=True, batch=B)
    pcc = k_pk.prepare(bsim._coeffs)
    errs = {}
    ck, cp = clone_carry(carry), clone_carry(carry)
    for tree, fe, fh in ((ck, packed.e_update, packed.h_update),
                         (cp, packed.e_update_plain, packed.h_update_plain)):
        fe(tree["E"], tree["H"], None, tree["psE"], pcc["E"], tree["rE"])
        fh(tree["H"], tree["E"], tree["psH"], pcc["H"], None, tree["rH"])
    torch.cuda.synchronize()
    errs["e_update + h_update"] = compare(
        ck, cp, "compensated lanes: one e_update + h_update launch",
        family=True)
    ck, cp = clone_carry(carry), clone_carry(carry)
    k_pk(ck, pcc)
    p_pk(cp, pcc)
    torch.cuda.synchronize()
    errs["packed step"] = compare(ck, cp, "compensated lanes: one "
                                  "lane-capable packed step", family=True)
    del ck, cp
    if any(errs.values()):
        fail(f"compensated lanes: not bit-equal to the plain versions "
             f"({errs})")
    keys = ("E", "H", "rE", "rH", "psE", "psH")
    for fc_lane in (None,) + tuple(range(B)):
        if fc_lane is None:
            a = clone_carry(carry)
            fe, fh = pcc["E"], pcc["H"]
        else:
            a = solo_lane(carry, fc_lane)
            fe = packed.lane_fc(pcc["E"], fc_lane)
            fh = packed.lane_fc(pcc["H"], fc_lane)
        packed.e_update(a["E"], a["H"], None, a["psE"], fe, a["rE"])
        packed.h_update(a["H"], a["E"], a["psH"], fh, None, a["rH"])
        torch.cuda.synchronize()
        a = {k: a[k] for k in keys}
        if fc_lane is None:
            batched = a
        else:
            assert_lanes_equal(batched, fc_lane, a,
                               "compensated lanes: e_update + h_update")
    say(f"compensated lanes ({B} at {size}^3): the lane-capable launches "
        f"and step equal their plain versions ({errs}) and every lane the "
        f"same kernels run solo, bit for bit")
    out = {"lanes": B, "shape": list(static.grid_shape),
           "max_abs_err": max(errs.values())}
    if times:
        out.update(lane_update_times(bsim, pcc, 20, 2))
        del bsim, carry, batched, a
        torch.cuda.empty_cache()
        out["main_path"] = lane_main_path(cfgs, "compensated lanes", 8,
                                          dev)
        say("compensated lanes: " + json.dumps(out))
    torch.cuda.empty_cache()
    return out



# --------------------------------------------------------------------------
# durable runs: checkpoints, resume, the supervised ladder (phase 26)
# --------------------------------------------------------------------------

DURABLE_DIR = os.path.join(OUT_DIR, "durable")
# the supervised ladder's rungs on the card, NaNs at t = 20, 40, 60, 80
LADDER_RUNGS = ("packed_tb_cuda", "packed_cuda", "fused_cuda",
                "pallas3d_cuda", "plain")
# each CUDA rung's kernel counts (ladder_launches keys)
RUNG_KERNELS = {"packed_tb_cuda": ("tb_pass",),
                "packed_cuda": ("e_update", "h_update"),
                "fused_cuda": ("fused_eh",),
                "pallas3d_cuda": ("e_family", "h_family")}


def checkpoint_numbers(dtype, dev, size=256):
    """Phase 26 (a): a ``Simulation`` of vacuum3D_tfsf at ``size``^3 in
    ``dtype`` 20 steps in: the seconds of ``checkpoint`` and of
    ``restore``, the file's MB, and the device memory each adds at its
    peak over what the sim holds (``max_memory_allocated`` from a reset
    just before), gated at one leaf's bytes; the restore must write into
    the live carry's own tensors (their addresses unchanged) and give
    back the checkpointed state bit for bit after 6 more steps."""
    import torch
    from fdtd3d_torch.sim import Simulation
    os.makedirs(DURABLE_DIR, exist_ok=True)
    path = os.path.join(DURABLE_DIR, f"ck_{dtype}.npz")
    sim = Simulation(config(EXAMPLE, ["--same-size", str(size), "--dtype",
                                      dtype]), device=dev)
    sim.advance(20)
    want = {k: v.clone() for k, v in leaves(sim._dict_view())}
    leaf_max = max(v.numel() * v.element_size() for v in want.values())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sim.checkpoint(path)
    ck_s = time.time() - t0
    ck_extra = torch.cuda.max_memory_allocated() - base
    sim.advance(6)
    torch.cuda.synchronize()
    ptrs = {k: v.data_ptr() for k, v in leaves(sim._dict_view())}
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    sim.restore(path)
    torch.cuda.synchronize()
    rs_s = time.time() - t0
    rs_extra = torch.cuda.max_memory_allocated() - base
    got = dict(leaves(sim._dict_view()))
    rec = {"size": size, "dtype": dtype, "step_kind": sim.step_kind,
           "checkpoint_s": ck_s, "restore_s": rs_s,
           "file_mb": os.path.getsize(path) / 1e6,
           "state_mb": sum(v.numel() * v.element_size()
                           for v in want.values()) / 1e6,
           "leaf_max_bytes": leaf_max,
           "checkpoint_peak_extra_bytes": ck_extra,
           "restore_peak_extra_bytes": rs_extra,
           "restore_in_place": {k: v.data_ptr() for k, v in got.items()}
           == ptrs}
    say(f"checkpoint numbers: {json.dumps(rec)}")
    if sim.t != 20 or not all(torch.equal(got[k], v)
                              for k, v in want.items()):
        fail(f"{dtype}: the restored state is not the checkpointed one")
    if ck_extra > leaf_max or rs_extra > leaf_max:
        fail(f"{dtype}: checkpoint/restore added {ck_extra}/{rs_extra} B "
             f"of device memory, more than one leaf ({leaf_max} B)")
    if not rec["restore_in_place"]:
        fail(f"{dtype}: restore replaced the live carry's tensors")
    del sim, want, got
    os.remove(path)
    torch.cuda.empty_cache()
    return rec


def killed_cli(argv, plan, label):
    """The CLI in a child process under the fault plan ``plan``: it must
    end with a non-zero exit (the simulated preemption)."""
    env = dict(os.environ, FDTD3D_FAULT_PLAN=plan,
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-m", "fdtd3d_torch.cli"]
                          + argv, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600, check=False)
    tail = (proc.stderr.strip().splitlines() or [""])[-1]
    say(f"{label}: killed run under {plan!r} exited {proc.returncode} in "
        f"{time.time() - t0:.1f} s ({tail})")
    if proc.returncode == 0 or "SimulatedPreemption" not in proc.stderr:
        fail(f"{label}: the run under {plan!r} was not preempted "
             f"(rc {proc.returncode}): {proc.stderr[-2000:]}")
    return time.time() - t0


def cli_logged(argv, label):
    """cli.main(argv) in this process with every kernel count set to 0
    just before and read just after: (stdout, stderr, launches, wall,
    peak device memory)."""
    import torch
    from fdtd3d_torch import cli
    out, err = _io.StringIO(), _io.StringIO()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    from fdtd3d_torch.ops import packed_ds
    t0 = time.time()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(ladder_launches(),
                    ds_pass=packed_ds.ds_pass.launches,
                    ds_line=packed_ds.line_advance.launches)
    say(f"cli ({label}): " + " | ".join(out.getvalue().strip().splitlines()
                                        + err.getvalue().strip()
                                        .splitlines()[-6:]))
    if rc != 0:
        fail(f"{label}: cli.main returned {rc}")
    return (out.getvalue(), err.getvalue(), launches, wall,
            torch.cuda.max_memory_allocated())


def same_dumps(dir_a, dir_b, steps, label):
    """Every DAT dump of step ``steps`` in the two directories equal
    byte for byte."""
    for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        name = f"{c}_t{steps:06d}.dat"
        with open(os.path.join(dir_a, name), "rb") as fa, \
                open(os.path.join(dir_b, name), "rb") as fb:
            if fa.read() != fb.read():
                fail(f"{label}: {name} of the resumed run differs from "
                     f"the uninterrupted run's")


def kill_and_resume(label, base_argv, every, kill, steps, kind, counter,
                    per_call, clean=None):
    """Phase 26 (b): the CLI with ``--checkpoint-every every``
    uninterrupted, then killed at ``kill`` (a child process under
    ``preempt@t=kill``) and resumed with ``--resume auto``: the resumed
    run runs ``kind`` for the remaining steps only (``counter`` launches,
    ``per_call`` steps a launch) and its dumps equal the uninterrupted
    run's byte for byte. With ``clean`` (the directory of an earlier
    uninterrupted run of the same flags) the killed run's newest
    snapshot is damaged (``corrupt_ckpt``), and the resume falls back to
    the one before it."""
    corrupt = clean is not None
    killed = os.path.join(DURABLE_DIR, f"{label}_killed")
    shutil.rmtree(killed, ignore_errors=True)
    flags = base_argv + ["--checkpoint-every", str(every), "--save-res",
                         str(steps), "--check-finite"]
    wall = launches = None
    if not corrupt:
        clean = os.path.join(DURABLE_DIR, f"{label}_clean")
        shutil.rmtree(clean, ignore_errors=True)
        _o, _e, launches, wall, _p = cli_logged(
            flags + ["--save-dir", clean], f"{label} uninterrupted")
    n_ckpt = kill // every
    plan = f"preempt@t={kill}"
    if corrupt:
        plan = f"corrupt_ckpt@n={n_ckpt}; " + plan
    killed_s = killed_cli(flags + ["--save-dir", killed], plan, label)
    from fdtd3d_torch import io
    if [t for t, _ in io.find_checkpoints(killed)][:1] != [kill]:
        fail(f"{label}: the killed run left {io.find_checkpoints(killed)}")
    start = kill - every if corrupt else kill
    out, err, r_launches, r_wall, r_peak = cli_logged(
        flags + ["--save-dir", killed, "--resume", "auto"],
        f"{label} resumed")
    want_from = f"ckpt_t{start:06d}.npz at t={start}"
    if want_from not in out or f"step_kind={kind}" not in out:
        fail(f"{label}: the resume did not start from {want_from} on "
             f"{kind}")
    if corrupt and "skipping unusable checkpoint" not in err:
        fail(f"{label}: the corrupt snapshot was not skipped")
    want = (steps - start) // per_call
    if r_launches[counter] != want:
        fail(f"{label}: the resumed run made {r_launches[counter]} "
             f"{counter} launches, not {want}")
    same_dumps(clean, killed, steps, label)
    rec = {"steps": steps, "checkpoint_every": every, "kill_at": kill,
           "resumed_from": start, "kind": kind,
           "uninterrupted_wall_s": wall, "uninterrupted_launches":
           launches, "killed_wall_s": killed_s, "resumed_wall_s": r_wall,
           "resumed_launches": r_launches, "peak_mem_bytes": r_peak,
           "bit_equal": True, "corrupt_fallback": corrupt}
    say(f"kill and resume ({label}): {json.dumps(rec)}")
    shutil.rmtree(killed, ignore_errors=True)
    return rec, clean


def supervised_ladder(base_argv, clean_dir, steps, dev, size=256):
    """Phase 26 (c): ``--supervise --checkpoint-every 10`` with NaNs at
    t = 20, 40, 60, 80: each trip rolls back and steps one rung down
    ``LADDER_RUNGS`` (the supervisor's log names each degrade), every
    CUDA rung launches its kernels, the run ends on the plain step at
    ``steps`` with finite dumps within ``LADDER_REL`` of the family max
    of the unsupervised run's (``clean_dir``); the peak device memory,
    and at each degrade the memory before it and when the next rung's
    build starts, by which time the tripped sim must be released. Then
    a trip on the plain step re-raises."""
    import torch
    from fdtd3d_torch import faults
    from fdtd3d_torch.supervisor import RetryPolicy, Supervisor
    out_dir = os.path.join(DURABLE_DIR, "supervised")
    shutil.rmtree(out_dir, ignore_errors=True)
    plan = "nan@t=20; nan@t=40; nan@t=60; nan@t=80"
    swaps = []
    real_swap = Supervisor._swap_sim

    def swap(sup, cfg):
        # the device memory while a degrade builds the next rung: before
        # the swap (the tripped sim held), when the build starts (the
        # tripped sim must be gone by then), peak during the build, after
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        tripped = weakref.ref(sup.sim)
        build, at_build = sup._factory, {}

        def factory(c):
            at_build.update(released=tripped() is None,
                            allocated=torch.cuda.memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return build(c)

        sup._factory = factory
        try:
            real_swap(sup, cfg)
        finally:
            sup._factory = build
        torch.cuda.synchronize()
        swaps.append({"kind": sup.sim.step_kind,
                      "allocated_before": before,
                      "tripped_released": at_build["released"],
                      "allocated_at_build": at_build["allocated"],
                      "peak": torch.cuda.max_memory_allocated(),
                      "allocated_after": torch.cuda.memory_allocated()})

    faults.clear()
    os.environ["FDTD3D_FAULT_PLAN"] = plan
    Supervisor._swap_sim = swap
    # what the card holds outside the supervised run (earlier phases'
    # tensors): the tripped sim's memory is measured above it
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    try:
        out, err, launches, wall, peak = cli_logged(
            base_argv + ["--supervise", "--checkpoint-every", "10",
                         "--save-res", str(steps), "--save-dir", out_dir],
            "supervised ladder")
    finally:
        Supervisor._swap_sim = real_swap
        os.environ.pop("FDTD3D_FAULT_PLAN")
        faults.clear()
    degrades = [ln.split("degraded ")[1].split(" -> ")
                for ln in err.splitlines() if " and degraded " in ln]
    want = [[a, b] for a, b in zip(LADDER_RUNGS, LADDER_RUNGS[1:])]
    if degrades != want:
        fail(f"supervised ladder: degrades {degrades} != {want}")
    if "supervisor: 0 retries, 4 rollbacks, 4 ladder degrades (now " \
            "plain)" not in out:
        fail("supervised ladder: the supervisor's closing line is missing")
    for sw in swaps:
        # one carry at a time: the tripped sim is released before the
        # next rung is built
        if not sw["tripped_released"] or 2 * (
                sw["allocated_at_build"] - base) > \
                sw["allocated_before"] - base:
            fail(f"supervised ladder: the tripped sim was still on the "
                 f"card when {sw['kind']} was built: {sw}")
    for rung, keys in RUNG_KERNELS.items():
        if not all(launches[k] > 0 for k in keys):
            fail(f"supervised ladder: {rung} launched "
                 f"{[launches[k] for k in keys]}")
    got = load_dumps(out_dir, steps, (size,) * 3, "supervised ladder")
    ref = load_dumps(clean_dir, steps, (size,) * 3, "unsupervised")
    rel = rel_fields(got, ref)
    if not rel <= LADDER_REL:
        fail(f"supervised ladder: rel {rel:.3e} vs the unsupervised run "
             f"> {LADDER_REL}")
    # a trip at the bottom is physics: it re-raises
    faults.install("nan@t=10")
    cfg = config(EXAMPLE, ["--same-size", str(size), "--use-pallas",
                           "off"])
    sup = Supervisor(cfg, device=dev, policy=RetryPolicy(
        sleep=lambda _s: None))
    try:
        sup.run(time_steps=20, interval=10)
        fail("a trip on the plain step did not re-raise")
    except FloatingPointError:
        bottom = sup.sim.step_kind
    finally:
        faults.clear()
    del sup
    torch.cuda.empty_cache()
    rec = {"steps": steps, "plan": plan, "wall_s": wall,
           "degrades": degrades, "launches": launches,
           "peak_mem_bytes": peak, "allocated_outside": base,
           "swaps": swaps,
           "rel_vs_unsupervised": rel, "bottom_reraised_on": bottom}
    say(f"supervised ladder: {json.dumps(rec)}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def durable_runs(dev, size=256, ds_plan=(250, 500, 1000)):
    """Phase 26: the durable-run path (npz checkpoints, --resume, the
    supervisor) at the main path's width, vacuum3D_tfsf at ``size``^3
    for 150 steps, f32 and bf16, and the float32x2 example as it stands
    (128^3, 1000 steps; ``ds_plan``: cadence, kill step, steps)."""
    import torch
    rec = {"checkpoint": {dt: checkpoint_numbers(dt, dev, size)
                          for dt in ("float32", "bfloat16")}}
    main = ["--cmd-from-file", EXAMPLE, "--same-size", str(size)]
    rec["resume_float32"], clean = kill_and_resume(
        "f32", main, 50, 100, 150, "packed_tb_cuda", "tb_pass", 2)
    rec["resume_float32_corrupt"], _c = kill_and_resume(
        "f32_corrupt", main, 50, 100, 150, "packed_tb_cuda", "tb_pass", 2,
        clean=clean)
    rec["supervised_ladder"] = supervised_ladder(main, clean, 150, dev,
                                                 size)
    shutil.rmtree(clean, ignore_errors=True)
    rec["resume_bfloat16"], clean = kill_and_resume(
        "bf16", main + BF16, 50, 100, 150, "packed_tb_cuda", "tb_pass", 2)
    shutil.rmtree(clean, ignore_errors=True)
    every, kill, steps = ds_plan
    rec["resume_float32x2"], clean = kill_and_resume(
        "ds", ["--cmd-from-file", PRECISION, "--time-steps", str(steps)],
        every, kill, steps, "packed_ds_cuda", "ds_pass", 1)
    shutil.rmtree(DURABLE_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return rec


# --------------------------------------------------------------------------
# every scheme mode and every output of the CLI (phases 27 and 28)
# --------------------------------------------------------------------------

MODES_DIR = os.path.join(OUT_DIR, "modes")
MODE_EXAMPLES = ("vacuum1D_ezhy.txt", "vacuum2D_tmz.txt",
                 "drude1D_metal.txt", "metamaterial1D_dng.txt")
# a 1D/2D example's norms on the card against the port's CPU run of the
# same file, relative to the family's largest norm
MODE_NORM_TOL = 1e-5
# the Mie far field at 256^3: the kernels' pattern against the plain
# step's, both normalised to their peak; bf16 against f32 at the bf16
# tracking bar
NTFF_PATTERN_TOL = 1e-4
# lines of a TXT dump held against the per-value Python formatter
TXT_PLAIN_LINES = 1 << 18


def done_mcps(log):
    """Mcells/s of the CLI's closing ``done:`` line."""
    done = [ln for ln in log.splitlines() if ln.startswith("done: ")]
    return float(done[-1].split("(")[1].split()[0]) if done else None


def mode_fields(out_dir, steps, comps):
    """Each component's DAT dump at ``steps``, as float64."""
    from fdtd3d_torch.io import load_dat
    return {c: load_dat(os.path.join(out_dir, f"{c}_t{steps:06d}.dat"))
            .astype("float64") for c in comps}


def mode_examples():
    """Phase 27 (a): each 1D/2D example as it stands through the CLI on
    the card, then on the CPU, with a DAT dump at its last step: the
    plain step (``packed_ineligible``) and no kernel launched, wall and
    Mcells/s on the card, and max |component| of the two runs' dumps
    within ``MODE_NORM_TOL`` of the family's largest."""
    import numpy as np
    from fdtd3d_torch.layout import SCHEME_MODES
    out = {}
    for name in MODE_EXAMPLES:
        path = os.path.join(ROOT, "Examples", name)
        cfg = config(path, [])
        steps = cfg.time_steps
        comps = SCHEME_MODES[cfg.scheme].components
        rec, fields = {"scheme": cfg.scheme, "size": list(cfg.grid_shape),
                       "steps": steps}, {}
        for dev_name, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
            d = os.path.join(MODES_DIR, f"{name[:-4]}_{dev_name}")
            shutil.rmtree(d, ignore_errors=True)
            (log, _err, launches, wall, _p), peak = peak_above(
                lambda: cli_logged(
                    ["--cmd-from-file", path, "--save-res", str(steps),
                     "--save-dir", d] + extra, f"{name} on {dev_name}"))
            if "step_kind=plain tb_fallback=packed_ineligible" not in log:
                fail(f"{name} on {dev_name}: not the plain step")
            if any(launches.values()):
                fail(f"{name}: a {cfg.scheme} run launched a 3D kernel: "
                     f"{launches}")
            fields[dev_name] = mode_fields(d, steps, comps)
            rec[f"wall_s_{dev_name}"] = wall
            rec[f"mcells_per_s_{dev_name}"] = done_mcps(log)
            if dev_name == "cuda":
                rec["peak_above_base_bytes"] = peak
            shutil.rmtree(d, ignore_errors=True)
        norms = {d: {c: float(np.abs(v).max()) for c, v in f.items()}
                 for d, f in fields.items()}
        worst = field_rel = 0.0
        for fam in "EH":
            members = [c for c in comps if c[0] == fam]
            scale = max(norms["cpu"][c] for c in members)
            for c in members:
                worst = max(worst, abs(norms["cuda"][c] - norms["cpu"][c])
                            / scale)
                field_rel = max(field_rel, float(np.abs(
                    fields["cuda"][c] - fields["cpu"][c]).max()) / scale)
        rec.update(norms_cuda=norms["cuda"], norm_rel_vs_cpu=worst,
                   field_rel_vs_cpu=field_rel)
        say(f"mode example {name}: {json.dumps(rec)}")
        if not worst <= MODE_NORM_TOL:
            fail(f"{name}: norms on the card {worst:.3e} from the CPU "
                 f"run's (> {MODE_NORM_TOL})")
        out[name] = rec
    return out


def tmz_large(size=4096, steps=1000):
    """Phase 27 (b): ``Examples/vacuum2D_tmz.txt`` at size^2 for
    ``steps`` steps through the CLI on the card: the plain step's
    Mcells/s and peak device memory, finite norms."""
    path = os.path.join(ROOT, "Examples", "vacuum2D_tmz.txt")
    d = os.path.join(MODES_DIR, "tmz_large")
    (log, _err, launches, wall, _p), peak = peak_above(lambda: cli_logged(
        ["--cmd-from-file", path, "--sizex", str(size), "--sizey",
         str(size), "--time-steps", str(steps), "--norms-every",
         str(steps // 10), "--save-dir", d], f"2D TMz at {size}^2"))
    if "step_kind=plain" not in log or any(launches.values()):
        fail(f"2D TMz at {size}^2: not the plain step ({launches})")
    last = [ln for ln in log.splitlines() if ln.startswith("[t=")][-1]
    ez = float(last.split("Ez=")[1].split()[0])
    if not 0.0 < ez < float("inf"):
        fail(f"2D TMz at {size}^2: Ez norm {ez}")
    rec = {"size": [size, size, 1], "steps": steps, "wall_s": wall,
           "mcells_per_s": done_mcps(log), "peak_above_base_bytes": peak,
           "ez_norm": ez}
    say(f"2D TMz at {size}^2: {json.dumps(rec)}")
    return rec


def mie_scaled(size):
    """``Examples/sphere3D_mie.txt`` at size^3, its sphere scaled with
    the grid (centre size/2, radius size/8)."""
    c = str(size // 2)
    return ["--cmd-from-file", MIE, "--same-size", str(size),
            "--eps-sphere-center-x", c, "--eps-sphere-center-y", c,
            "--eps-sphere-center-z", c, "--eps-sphere-radius",
            str(size // 8)]


@contextlib.contextmanager
def timed_writers(seconds):
    """io's DAT, TXT and BMP writers timed, summed per format into
    ``seconds`` (and counted under ``<format>_files``)."""
    from fdtd3d_torch import io as tio
    real = {f: getattr(tio, f"dump_{f}") for f in ("dat", "txt", "bmp")}

    def wrap(fmt, fn):
        def timed(*a, **k):
            t0 = time.perf_counter()
            fn(*a, **k)
            seconds[fmt] = seconds.get(fmt, 0.0) + time.perf_counter() - t0
            seconds[f"{fmt}_files"] = seconds.get(f"{fmt}_files", 0) + 1
        return timed

    for fmt, fn in real.items():
        setattr(tio, f"dump_{fmt}", wrap(fmt, fn))
    try:
        yield seconds
    finally:
        for fmt, fn in real.items():
            setattr(tio, f"dump_{fmt}", fn)


def same_text_as_host(out_dir, name, axes, label):
    """``name``'s TXT and BMP dumps equal the host writers' output for
    its DAT dump's exact values, and the TXT's first ``TXT_PLAIN_LINES``
    lines equal the per-value Python ``%.9e`` formatter's."""
    import filecmp

    import numpy as np
    from fdtd3d_torch import io as tio
    vals = tio.load_dat(os.path.join(out_dir, name + ".dat"))
    again = os.path.join(out_dir, "again")
    tio.dump_txt(vals, again + ".txt")
    tio.dump_bmp(vals, again + ".bmp", axes)
    for ext in ("txt", "bmp"):
        if not filecmp.cmp(again + "." + ext,
                           os.path.join(out_dir, f"{name}.{ext}"),
                           shallow=False):
            fail(f"{label}: {name}.{ext} differs from the host writer's "
                 f"output for the same array")
        os.remove(again + "." + ext)
    flat = vals.reshape(-1)[:TXT_PLAIN_LINES]
    idx = np.unravel_index(np.arange(flat.size), vals.shape)
    plain = "".join(
        " ".join(str(int(i[n])) for i in idx) + f" {float(v):.9e}\n"
        for n, v in enumerate(flat.tolist())).encode()
    with open(os.path.join(out_dir, name + ".txt"), "rb") as f:
        head = f.read(len(plain))
    if head != plain:
        fail(f"{label}: {name}.txt's first {flat.size} lines differ from "
             f"the per-value formatter's")


def dump_numbers(size=256, steps=20):
    """Phase 27 (c): TXT and BMP field dumps (``--save-formats
    dat,txt,bmp``) and ``--save-materials`` at size^3 through the CLI on
    the card, on the Mie example scaled (its sphere shapes the eps
    grids): each format's writer seconds summed over its files, the TXT
    files' bytes; Ez's and eps_Ex's TXT and BMP against the host writers
    on their DAT dumps' values (``same_text_as_host``). Each run's files
    are removed after its checks (a 256^3 TXT dump is ~0.5 GB)."""
    axes = (0, 1, 2)
    rec = {"size": size}
    d = os.path.join(MODES_DIR, "dumps")
    shutil.rmtree(d, ignore_errors=True)
    with timed_writers({}) as seconds:
        log, _err, launches, wall, _peak = cli_logged(
            mie_scaled(size) + ["--time-steps", str(steps), "--save-res",
                                str(steps), "--save-formats",
                                "dat,txt,bmp", "--save-dir", d],
            f"TXT/BMP dumps at {size}^3")
    if "step_kind=packed_tb_cuda" not in log:
        fail("TXT/BMP dumps: the run did not take the tb pass")
    txt_bytes = sum(os.path.getsize(os.path.join(d, f))
                    for f in os.listdir(d) if f.endswith(".txt"))
    rec["fields"] = dict(seconds, wall_s=wall, txt_bytes=txt_bytes,
                         launches=launches)
    same_text_as_host(d, f"Ez_t{steps:06d}", axes, "field dumps")
    shutil.rmtree(d, ignore_errors=True)
    with timed_writers({}) as seconds:
        log, _err, _l, wall, _peak = cli_logged(
            mie_scaled(size) + ["--time-steps", "2", "--save-materials",
                                "--save-formats", "dat,txt,bmp",
                                "--save-dir", d],
            f"--save-materials at {size}^3")
    names = sorted(f for f in os.listdir(d) if f.endswith(".txt"))
    want = sorted(f"{g}.txt" for g in ("eps_Ex", "eps_Ey", "eps_Ez",
                                       "mu_Hx", "mu_Hy", "mu_Hz",
                                       "sigma_e", "sigma_m"))
    if names != want:
        fail(f"--save-materials wrote {names}, not {want}")
    rec["materials"] = dict(seconds, wall_s=wall, files=len(os.listdir(d)))
    same_text_as_host(d, "eps_Ex", axes, "--save-materials")
    shutil.rmtree(d, ignore_errors=True)
    say(f"dump numbers at {size}^3: {json.dumps(rec)}")
    return rec


def modes_and_outputs():
    """Phase 27: the 1D/2D examples, 2D TMz at 4096^2, and the TXT/BMP
    dumps and --save-materials at 256^3."""
    rec = {"examples": mode_examples(), "tmz_4096": tmz_large()}
    rec["dumps_256"] = dump_numbers()
    shutil.rmtree(MODES_DIR, ignore_errors=True)
    return rec


class NtffProbe:
    """Wraps ``cli.make_ntff_collector`` for one CLI run: keeps the
    collector, and times each sample on the device (CUDA events around
    it, read after the run)."""

    def __init__(self):
        from fdtd3d_torch import cli
        self.cli, self.real = cli, cli.make_ntff_collector
        self.col, self.events = None, []

    def __enter__(self):
        import torch

        def make(sim, cfg):
            col, every, start = self.real(sim, cfg)
            self.col, self.every, self.start = col, every, start
            if col is not None:
                sample = col.sample

                def timed():
                    ev = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                    ev[0].record()
                    sample()
                    ev[1].record()
                    self.events.append(ev)
                col.sample = timed
            return col, every, start
        self.cli.make_ntff_collector = make
        return self

    def __exit__(self, *exc):
        self.cli.make_ntff_collector = self.real
        if self.col is not None:
            # the timed wrapper closes over the collector: drop it, so
            # no reference cycle keeps the collector and its sim alive
            self.col.__dict__.pop("sample", None)

    def sample_ms(self):
        import torch
        torch.cuda.synchronize()
        times = [a.elapsed_time(b) for a, b in self.events]
        return sum(times) / len(times) if times else None


def tb_launches(steps, interval):
    """(tb passes, packed tail steps) of a run of ``steps`` in chunks of
    ``interval`` (0: one chunk): a chunk of n steps is n // 2 passes and
    n % 2 tail steps."""
    chunks = [interval] * (steps // interval) + [steps % interval] \
        if interval else [steps]
    return sum(n // 2 for n in chunks), sum(n % 2 for n in chunks)


def read_pattern(out_dir, cfg, label):
    import numpy as np
    path = os.path.join(out_dir, "ntff_pattern.txt")
    if not os.path.exists(path):
        fail(f"{label}: no ntff_pattern.txt")
    rows = np.loadtxt(path)
    n = cfg.ntff.theta_steps * cfg.ntff.phi_steps
    if rows.shape != (n, 3) or not np.isfinite(rows).all() \
            or abs(rows[:, 2].max() - 1.0) > 1e-12:
        fail(f"{label}: bad pattern ({rows.shape}, peak "
             f"{rows[:, 2].max()})")
    return rows[:, 2]


def peak_above(fn):
    """(fn(), the peak device memory during it above what the card held
    just before, in bytes)."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    out = fn()
    return out, torch.cuda.max_memory_allocated() - base


def mie_ntff_512(size=512):
    """Phase 28 (a): the Mie example as it stands (512^3 f32, 800 steps)
    with ``--ntff``, keeping its ``--norms-every 200`` (the NTFF cadence,
    13, makes the chunk interval gcd(200, 13) = 1: 800 chunks of one
    packed step) and with ``--norms-every 0`` (chunks of 13: six tb passes
    and a packed tail): kinds and launches (gated against the chunking),
    wall, Mcells/s, peak memory above the card's baseline, the samples
    (31, from t=403), the device ms a sample (CUDA events) and its
    device launches (one more sample under the profiler after the run),
    the accumulators' device bytes, and, on the run's live sim after it,
    one chunk of each run's interval under the profiler (and a chunk of
    12: the passes without the tail) and 26 steps as the CLI runs them.
    Beside each, the same run without ``--ntff``: the first run's sim
    stepped again for 800 steps in the chunks the CLI takes without
    ``--ntff`` (200 with the norms, whose readback it makes; one chunk
    without), no sampling: the same kernels on the same coefficients,
    without a second 512^3 set-up. At 800 steps the wave scattered by
    the sphere has not reached the NTFF box (~1200 steps away), so the
    faces hold the TFSF boundary's roundoff: the two patterns are
    recorded, not gated against each other (the pattern gate is phase
    28 (b)'s, at 256^3)."""
    import math

    import numpy as np
    import torch
    from fdtd3d_torch import diag
    cfg = config(MIE, mie_scaled(size)[2:])
    steps = cfg.time_steps
    cells = float(size) ** 3
    rec, patterns = {}, {}
    for label, extra in (("ntff_norms200", ["--ntff"]),
                         ("ntff", ["--ntff", "--norms-every", "0"])):
        d = os.path.join(MODES_DIR, f"mie{size}_{label}")
        shutil.rmtree(d, ignore_errors=True)
        with NtffProbe() as probe:
            (log, _err, launches, wall, _p), peak = peak_above(
                lambda: cli_logged(mie_scaled(size) + ["--save-dir", d]
                                   + extra, f"Mie {size}^3 {label}"))
        col, every = probe.col, probe.every
        interval = math.gcd(config(MIE, extra).output.norms_every, every)
        passes, tails = tb_launches(steps, interval)
        got = {k: launches[k] for k in ("tb_pass", "e_update", "h_update")}
        if got != {"tb_pass": passes, "e_update": tails,
                   "h_update": tails}:
            fail(f"Mie {label}: launches {got}, chunks of {interval} "
                 f"want {passes} passes and {tails} tails")
        want_n = len(range(probe.start, steps + 1, every))
        if col.n_samples != want_n:
            fail(f"Mie {label}: {col.n_samples} samples != {want_n}")
        patterns[label] = read_pattern(d, cfg, f"Mie {label}")
        r = {"interval": interval, "launches": got, "wall_s": wall,
             "mcells_per_s": done_mcps(log), "peak_above_base_bytes": peak,
             "samples": col.n_samples, "sample_device_ms": probe.sample_ms(),
             "ntff_every": every, "ntff_start": probe.start,
             "acc_device_bytes": col.device_bytes(),
             "box": [list(col.lo), list(col.hi)]}
        # the pattern's evaluation on the host (the CLI times it inside
        # its run: the done line's Mcells/s counts it)
        t0 = time.time()
        col.directivity_pattern(np.linspace(0.0, 180.0,
                                            cfg.ntff.theta_steps),
                                np.arange(cfg.ntff.phi_steps)
                                * (360.0 / cfg.ntff.phi_steps))
        r["pattern_host_s"] = time.time() - t0
        # after the pattern: one more sample, one chunk of the run's
        # interval (and of 12 steps) and 26 steps as the CLI runs them (a
        # sample at each multiple of the cadence), each under the profiler
        _w, dev_us, n_launch, _k = device_launches(col.sample)
        r.update(sample_launches=n_launch,
                 sample_profiled_device_ms=dev_us / 1e3)
        col.sim.advance(2)     # the tb pass's first call prepares
        for n in sorted({interval, 12}):
            wall_us, dev_us, n_launch, _k = device_launches(
                lambda: col.sim.advance(n))
            r[f"chunk_{n}_profiled"] = {
                "wall_ms": wall_us / 1e3, "device_ms": dev_us / 1e3,
                "launches": n_launch}
        col.sim.advance(-col.sim.t % every)

        def window():
            col.sim.run(2 * every, interval=interval, on_interval=(
                lambda sm: col.sample() if sm.t % every == 0 else None))
        wall_us, dev_us, n_launch, _k = device_launches(window)
        r["window_26_profiled"] = {
            "wall_ms": wall_us / 1e3, "device_ms": dev_us / 1e3,
            "launches": n_launch, "device_busy_share": dev_us / wall_us}
        if label == "ntff_norms200":
            for base, norms in (("norms200", 200), ("plain_cadence", 0)):
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.time()
                col.sim.run(steps, interval=norms, on_interval=(
                    diag.field_norms if norms else None))
                torch.cuda.synchronize()
                wall = time.time() - t0
                got = {k: v for k, v in ladder_launches().items()
                       if k in ("tb_pass", "e_update", "h_update")}
                if got != {"tb_pass": steps // 2, "e_update": 0,
                           "h_update": 0}:
                    fail(f"Mie {base}: launches {got}")
                rec[base] = {"interval": norms, "launches": got,
                             "stepping_wall_s": wall,
                             "mcells_per_s": cells * steps / wall / 1e6}
                say(f"Mie {size}^3 {base}: {json.dumps(rec[base])}")
        del col
        probe.col = None
        rec[label] = r
        say(f"Mie {size}^3 {label}: {json.dumps(r)}")
        shutil.rmtree(d, ignore_errors=True)
    rec["pattern_rel_tb_vs_packed"] = float(np.abs(
        patterns["ntff"] - patterns["ntff_norms200"]).max())
    return rec


def mie_pattern_gate(size=256, steps=1200):
    """Phase 28 (b): the Mie example scaled to size^3 with ``--ntff
    --norms-every 0`` for ``steps`` steps (sampled from steps/2: at
    256^3 the wave scattered by the sphere reaches the NTFF box at
    ~560 steps, so from 600 on the faces hold it) on the kernels (tb
    passes and packed tails), on the plain step (``--use-pallas off``)
    and on the bf16 kernels: the kernels' pattern within
    ``NTFF_PATTERN_TOL`` of the plain step's, bf16's within
    ``BF16_TRACK`` of f32's (each normalised to its peak). Recorded, not
    gated: bf16 against f32 at the example's 800 steps, whose samples
    from 403 also hold the faces before the scattered wave, where bf16
    storage floors the field at its rounding (~1e-2 of the incident
    wave) and f32 at ~1e-7."""
    import numpy as np
    cfg = config(MIE, ["--same-size", str(size)])
    rec, patterns = {}, {}
    for label, n, extra, kind in (
            ("kernels", steps, [], "packed_tb_cuda"),
            ("plain", steps, ["--use-pallas", "off"], "plain"),
            ("bf16", steps, BF16, "packed_tb_cuda"),
            ("kernels_800", 800, [], "packed_tb_cuda"),
            ("bf16_800", 800, BF16, "packed_tb_cuda")):
        d = os.path.join(MODES_DIR, f"mie{size}_{label}")
        (log, _err, launches, wall, _p), peak = peak_above(
            lambda: cli_logged(
                mie_scaled(size) + ["--ntff", "--norms-every", "0",
                                    "--time-steps", str(n), "--save-dir",
                                    d] + extra, f"Mie {size}^3 {label}"))
        if f"step_kind={kind}" not in log:
            fail(f"Mie {size}^3 {label}: not {kind}")
        patterns[label] = read_pattern(d, cfg, f"Mie {size}^3 {label}")
        rec[label] = {"steps": n, "launches": {
            k: launches[k] for k in ("tb_pass", "e_update", "h_update")},
            "wall_s": wall, "mcells_per_s": done_mcps(log),
            "peak_above_base_bytes": peak}
        shutil.rmtree(d, ignore_errors=True)

    def rel(a, b):
        return float(np.abs(patterns[a] - patterns[b]).max())
    rec.update(kernels_vs_plain=rel("kernels", "plain"),
               bf16_vs_f32=rel("bf16", "kernels"),
               bf16_vs_f32_800=rel("bf16_800", "kernels_800"))
    say(f"Mie {size}^3 pattern gate: {json.dumps(rec)}")
    if not rec["kernels_vs_plain"] <= NTFF_PATTERN_TOL:
        fail(f"Mie {size}^3: the kernels' pattern is "
             f"{rec['kernels_vs_plain']:.3e} from the plain step's")
    if not rec["bf16_vs_f32"] <= BF16_TRACK:
        fail(f"Mie {size}^3: bf16's pattern is {rec['bf16_vs_f32']:.3e} "
             f"from f32's")
    return rec


def dipole_cfg(n, steps=0):
    from fdtd3d_torch.config import PmlConfig, PointSourceConfig, SimConfig
    return SimConfig(scheme="3D", size=(n, n, n), time_steps=steps,
                     dx=1e-3, courant_factor=0.5, wavelength=12e-3,
                     pml=PmlConfig(size=(8, 8, 8)),
                     point_source=PointSourceConfig(
                         enabled=True, component="Ez",
                         position=(n // 2,) * 3))


def dipole_gates(dev, n=64):
    """Phase 28 (c): tests/test_exact_ntff.py:111 on the card: a
    z-directed point current at n^3 on the tb pass (a stride of 3: one
    pass and a packed tail between samples), 300 steps, then 48 samples
    on the box n/4..3n/4: the sin^2(theta) gates."""
    from fdtd3d_torch import physics
    from fdtd3d_torch.ntff import NtffCollector
    from fdtd3d_torch.sim import Simulation
    cfg = dipole_cfg(n)
    sim = Simulation(cfg, device=dev)
    if sim.step_kind != "packed_tb_cuda":
        fail(f"dipole: {sim.step_kind}")
    reset_launches()
    sim.advance(300)
    col = NtffCollector(sim, physics.C0 / cfg.wavelength,
                        box=((n // 4,) * 3, (n - n // 4,) * 3))
    stride = max(1, int(round(cfg.wavelength / physics.C0 / cfg.dt / 16)))
    for _ in range(48):
        sim.advance(stride)
        col.sample()
    launches = {k: v for k, v in ladder_launches().items()
                if k in ("tb_pass", "e_update", "h_update")}
    p90 = col.directivity_pattern([90.0], [0.0, 90.0, 180.0, 270.0])[0]
    rec = {"n": n, "stride": stride, "launches": launches,
           "phi_asymmetry": float(p90.max() / p90.min()),
           "diagonal": float(col.directivity_pattern([90.0], [45.0])[0, 0]
                             / p90.mean()),
           "r45": float(col.directivity_pattern([45.0], [0.0])[0, 0]
                        / p90.mean()),
           "r10": float(col.directivity_pattern([10.0], [0.0])[0, 0]
                        / p90.mean())}
    say(f"dipole at {n}^3: {json.dumps(rec)}")
    if not (rec["phi_asymmetry"] < 1.2 and 0.6 < rec["diagonal"] < 1.4
            and 0.35 < rec["r45"] < 0.75 and rec["r10"] < 0.15):
        fail(f"dipole at {n}^3: the pattern is not sin^2(theta): {rec}")
    if not (launches["tb_pass"] and launches["e_update"]):
        fail(f"dipole at {n}^3: launches {launches}")
    del sim, col
    return rec


def supervised_ntff(n=64, steps=240):
    """Phase 28 (d): a dipole at n^3 with ``--ntff --checkpoint-every 24``
    through the CLI, uninterrupted and ``--supervise`` with a NaN at
    t=168 (mid-sampling): the supervisor rolls back and degrades the tb
    pass to the packed step, the collector samples the live (degraded)
    sim, and the pattern stays within ``LADDER_REL`` of the
    uninterrupted run's."""
    import numpy as np
    from fdtd3d_torch import faults
    base = ["--3d", "--same-size", str(n), "--time-steps", str(steps),
            "--courant-factor", "0.5", "--wavelength", "12e-3",
            "--use-pml", "--pml-size", "8", "--point-source", "Ez",
            "--ntff", "--ntff-margin", "8", "--checkpoint-every", "24"]
    cfg = config(os.devnull, base)
    dirs = {k: os.path.join(MODES_DIR, f"dipole_{k}")
            for k in ("clean", "supervised")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    cli_logged(base + ["--save-dir", dirs["clean"]], "dipole clean")
    faults.clear()
    os.environ["FDTD3D_FAULT_PLAN"] = "nan@t=168"
    try:
        with NtffProbe() as probe:
            log, err, launches, wall, _peak = cli_logged(
                base + ["--supervise", "--save-dir", dirs["supervised"]],
                "dipole supervised")
    finally:
        os.environ.pop("FDTD3D_FAULT_PLAN")
        faults.clear()
    sampled = probe.col.sim.step_kind
    samples = probe.col.n_samples
    probe.col = None
    if "ladder degrades (now packed_cuda)" not in log \
            or sampled != "packed_cuda":
        fail(f"dipole supervised: no degrade to packed_cuda, or the "
             f"collector sampled {sampled}")
    rel = float(np.abs(read_pattern(dirs["supervised"], cfg, "supervised")
                       - read_pattern(dirs["clean"], cfg, "clean")).max())
    rec = {"n": n, "steps": steps, "wall_s": wall, "samples": samples,
           "launches": {
               k: launches[k] for k in ("tb_pass", "e_update",
                                        "h_update")},
           "pattern_rel_vs_uninterrupted": rel}
    say(f"dipole supervised: {json.dumps(rec)}")
    if not rel <= LADDER_REL:
        fail(f"dipole supervised: pattern {rel:.3e} from the clean run's")
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    return rec


def mie_far_field(dev):
    """Phase 28: the Mie far field at 512^3 (with and without
    --norms-every), the pattern gate at 256^3, the dipole's sin^2 gates
    at 64^3, a supervised NaN trip with the collector on the degraded
    sim."""
    rec = {"mie_512": mie_ntff_512(), "pattern_256": mie_pattern_gate(),
           "dipole_64": dipole_gates(dev),
           "supervised_64": supervised_ntff()}
    shutil.rmtree(MODES_DIR, ignore_errors=True)
    return rec


# --------------------------------------------------------------------------
# health counters, the telemetry sink and profiling (phase 29)
# --------------------------------------------------------------------------

OBS_DIR = os.path.join(OUT_DIR, "observability")
# phase 29 (a): the chunk counters of a kernel run against the same sim
# stepped by the plain step: max |E|, max |H| relative, the energy
# relative, div·E absolute against this x e_scale / dx (at normal
# incidence div·E is roundoff, so its relative error means nothing)
HEALTH_MAX_REL = 2e-6
HEALTH_ENERGY_REL = 1e-5
HEALTH_DIV_ABS = 1e-5
# (b) the --telemetry overhead on the 150-step 256^3 run's stepping wall
TELEMETRY_OVERHEAD = 0.02
# (c) the health pass's added peak device memory at 1024^3: a quarter of
# one f32 field volume
HEALTH_PEAK_BYTES = 1.1e9
# (f) the spans a trace of a telemetry run must hold
TRACE_SPANS = ("fdtd3d/chunk", "fdtd3d/telemetry-readback", "fdtd3d/health")


def read_records(path, label):
    """A telemetry JSONL read back through the port's validator."""
    from fdtd3d_torch import telemetry
    try:
        return telemetry.read_jsonl(path)
    except (OSError, ValueError) as exc:
        fail(f"{label}: telemetry file {path}: {exc}")


def chunks_of(recs):
    return [r for r in recs if r["type"] == "chunk"]


def counters_close(got, want, rel_max, rel_energy, div_abs, label):
    """The worst errors of one chunk record against another (max_e/max_h
    and energy relative, div·E absolute over ``div_abs`` x e_scale / dx,
    returned as a multiple of the gate); fails past a gate."""
    errs = {}
    for k, gate in (("max_e", rel_max), ("max_h", rel_max),
                    ("energy", rel_energy)):
        errs[k] = abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
        if not errs[k] <= gate:
            fail(f"{label}: {k} {got[k]!r} vs {want[k]!r} (rel "
                 f"{errs[k]:.3e} > {gate})")
    for k in ("div_l2", "div_linf"):
        errs[k] = abs(got[k] - want[k]) / max(div_abs, 1e-30)
        if not errs[k] <= 1.0:
            fail(f"{label}: {k} {got[k]!r} vs {want[k]!r} (over "
                 f"{div_abs:.3e} by {errs[k]:.3f}x)")
    return errs


def count_dtoh(fn):
    """``fn()`` under torch.profiler: the device-to-host copies it made
    (``Memcpy DtoH`` events) and the host extractions of tensors
    (``tolist``/``item``/``numpy``/``__float__``/``__bool__``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    calls = {}
    saved = {}

    def counting(name, orig):
        def wrapped(self, *a, **k):
            calls[name] = calls.get(name, 0) + 1
            return orig(self, *a, **k)
        return wrapped

    for name in ("tolist", "item", "numpy", "__float__", "__bool__"):
        saved[name] = getattr(torch.Tensor, name)
        setattr(torch.Tensor, name, counting(name, saved[name]))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for name, orig in saved.items():
            setattr(torch.Tensor, name, orig)
    dtoh = sum(ev.count for ev in prof.key_averages()
               if "DtoH" in ev.key or "Device -> Pageable" in ev.key)
    return dtoh, calls


def telemetry_main_path(dtype, steps, label):
    """Phase 29 (a): the CLI main path (vacuum3D_tfsf at 256^3) with
    ``--telemetry --per-chip-telemetry --metrics-every 50 --profile``:
    the launches (75 tb passes, one packed launch a family at 151),
    every record validated, one chunk record (and one per_chip) a chunk
    of 50 steps (the cadence: 25 passes each; 151 ends with a 1-step
    chunk), metrics.jsonl at 50/100/150, the profile line."""
    out_dir = os.path.join(OBS_DIR, f"main_{dtype}_{steps}")
    shutil.rmtree(out_dir, ignore_errors=True)
    path = os.path.join(out_dir, "telemetry.jsonl")
    argv = ["--cmd-from-file", EXAMPLE, "--same-size", "256",
            "--time-steps", str(steps), "--check-finite", "--save-dir",
            out_dir, "--dtype", dtype, "--telemetry", path,
            "--per-chip-telemetry", "--metrics-every", "50", "--profile"]
    out, _err, launches, wall, peak = cli_logged(argv, label)
    passes, tails = tb_launches(steps, 50)
    got = {k: launches[k] for k in ("tb_pass", "e_update", "h_update")}
    if got != {"tb_pass": passes, "e_update": tails, "h_update": tails}:
        fail(f"{label}: launches {got}, want {passes} passes and {tails} "
             f"tails")
    recs = read_records(path, label)
    types = [r["type"] for r in recs]
    n_chunks = -(-steps // 50)
    if types != ["run_start"] + ["chunk", "per_chip"] * n_chunks \
            + ["run_end"]:
        fail(f"{label}: record types {types}")
    if recs[0]["step_kind"] != "packed_tb_cuda" \
            or recs[0]["platform"] != "gpu":
        fail(f"{label}: run_start {recs[0]}")
    chunks = chunks_of(recs)
    if [c["t"] for c in chunks] != [min(50 * (i + 1), steps)
                                    for i in range(n_chunks)] \
            or not all(c["finite"] for c in chunks):
        fail(f"{label}: chunk records {chunks}")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        metrics = [json.loads(ln) for ln in f]
    if [m["t"] for m in metrics] != [50.0, 100.0, 150.0] or not all(
            m["energy"] > 0 and m["e_scale"] > 0 for m in metrics):
        fail(f"{label}: metrics.jsonl {metrics}")
    if "profile: " not in out or f"telemetry: {len(recs)} records" \
            not in out:
        fail(f"{label}: no profile or telemetry line")
    rec = {"dtype": dtype, "steps": steps, "launches": got,
           "cli_wall_s": wall, "stepping_s": done_seconds(out),
           "peak_mem_bytes": peak, "records": len(recs),
           "chunks": [{k: c[k] for k in ("t", "steps", "wall_s", "energy",
                                         "div_l2", "div_linf", "max_e",
                                         "max_h", "finite")}
                      for c in chunks],
           "metrics": metrics, "run_end": recs[-1]}
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def done_seconds(log):
    """The stepping wall of a CLI run's closing ``done:`` line."""
    import re
    m = re.search(r"done: \d+ steps in ([0-9.]+)s", log)
    if m is None:
        fail("no closing done: line")
    return float(m.group(1))


def plain_chunks(dtype, chunks, dev):
    """The main path's configuration on the plain step (no kernel), its
    health pass read after each of ``chunks`` (step counts): the chunk
    records of the same sim stepped by the plain step."""
    import torch
    from fdtd3d_torch import telemetry
    from fdtd3d_torch.sim import Simulation
    cfg = config(EXAMPLE, ["--same-size", "256", "--dtype", dtype,
                           "--use-pallas", "off"])
    sim = Simulation(cfg, device=dev)
    hfn = telemetry.make_health_fn(sim.static)
    out = []
    for n in chunks:
        sim.advance(n)
        out.append(dict(telemetry.readback(hfn(sim._dict_view())),
                        t=sim.t))
    dx = cfg.dx
    del sim
    torch.cuda.empty_cache()
    return out, dx


def health_counters_main_path(dev):
    """Phase 29 (a): f32 and bf16 at 150 and 151 steps through the CLI
    with the telemetry flags; the f32 chunk counters against the same sim
    on the plain step (2e-6 / 1e-5 / div absolute), bf16 against f32
    within ``BF16_TRACK`` of the f32 family max (div absolute at the same
    share of e_scale / dx); one device-to-host copy a chunk."""
    runs = {}
    for dtype in ("float32", "bfloat16"):
        for steps in (150, 151):
            runs[f"{dtype}_{steps}"] = telemetry_main_path(
                dtype, steps, f"telemetry {dtype} {steps}")
    plain, dx = plain_chunks("float32", (50, 50, 50, 1), dev)
    errs = {}
    for key in ("float32_150", "float32_151"):
        for c, p in zip(runs[key]["chunks"], plain):
            if c["t"] != p["t"]:
                fail(f"{key}: chunk t {c['t']} vs plain {p['t']}")
            e = counters_close(c, p, HEALTH_MAX_REL, HEALTH_ENERGY_REL,
                               HEALTH_DIV_ABS * p["max_e"] / dx,
                               f"{key} t={c['t']} vs plain")
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
    bf_errs = {}
    for steps in (150, 151):
        for c, f in zip(runs[f"bfloat16_{steps}"]["chunks"],
                        runs[f"float32_{steps}"]["chunks"]):
            e = counters_close(c, f, BF16_TRACK, BF16_TRACK,
                               BF16_TRACK * f["max_e"] / dx,
                               f"bf16 {steps} t={c['t']} vs f32")
            for k, v in e.items():
                bf_errs[k] = max(bf_errs.get(k, 0.0), v)
    # one device-to-host copy a chunk, on the card: a 50-step chunk of
    # the main path's sim with a sink, after a warm-up chunk
    from fdtd3d_torch.sim import Simulation
    path = os.path.join(OBS_DIR, "dtoh.jsonl")
    cfg = config(EXAMPLE, ["--same-size", "256", "--telemetry", path])
    sim = Simulation(cfg, device=dev)
    sim.advance(50)
    dtoh, calls = count_dtoh(lambda: sim.advance(50))
    sim.close()
    del sim
    say(f"one chunk with a sink: {dtoh} device-to-host copies, host "
        f"extractions {calls}")
    if dtoh != 1 or calls != {"tolist": 1}:
        fail(f"a chunk with health on made {dtoh} device-to-host copies "
             f"({calls}), not one")
    rec = {"runs": runs, "vs_plain_rel_or_gate_share": errs,
           "bf16_vs_f32_gate_share": bf_errs, "dtoh_per_chunk": dtoh,
           "host_extractions_per_chunk": calls}
    say(f"health counters: vs plain {errs}, bf16 vs f32 {bf_errs}")
    return rec


def trace_kernels(fn):
    """``fn()`` under torch.profiler, its Chrome trace read back: (device
    kernels, their summed device ms, the device ms of the port's spans
    on the GPU timeline). The span is the cross-check: in a long process
    the profiler has dropped kernel events (phase 29's whole-script runs
    read 0 kernels for a pass that reads 43 alone)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(OBS_DIR, exist_ok=True)
    path = os.path.join(OBS_DIR, "kernels.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    spans = [ev for ev in events if ev.get("cat") == "gpu_user_annotation"
             and ev.get("name", "").startswith("fdtd3d/")]
    return (len(kernels), sum(ev.get("dur", 0.0) for ev in kernels) / 1e3,
            sum(ev.get("dur", 0.0) for ev in spans) / 1e3)


def health_pass_cost(dev, reps=20, rounds=5):
    """Phase 29 (b): CUDA-event ms of one health pass on the main path's
    256^3 carry (tb pass, 150 steps in), its device kernels and their
    device ms from a trace, beside one tb step in the same call; then
    the main path's 150-step run (``Simulation.run`` of the CLI's
    configuration, one chunk, synchronised) with the finite check, with
    it and ``--telemetry``, and with neither (no health pass), three
    sims in turns (the order reversed every round) after a warm-up run
    each, min of ``rounds``."""
    import torch
    from fdtd3d_torch import telemetry
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(config(EXAMPLE, ["--same-size", "256"]), device=dev)
    sim.advance(150)
    hfn = telemetry.make_health_fn(sim.static)
    health_ms = timed(lambda: hfn(sim._dict_view()), reps)
    step_ms = timed(lambda: sim.advance(2), reps) / 2
    n_kernels, kernel_ms, span_ms = trace_kernels(
        lambda: hfn(sim._dict_view()))
    readback_ms = timed(lambda: telemetry.readback(hfn(sim._dict_view())),
                        reps)
    del sim, hfn
    torch.cuda.empty_cache()
    extra = {"finite": ["--check-finite"],
             "telemetry": ["--check-finite", "--telemetry",
                           os.path.join(OBS_DIR, "ab.jsonl")],
             "no_health": []}
    sims = {k: Simulation(config(EXAMPLE, ["--same-size", "256"] + v),
                          device=dev) for k, v in extra.items()}
    walls = {k: [] for k in sims}
    for key, s in sims.items():
        s.run(150)
    for r in range(rounds):
        for key in (list(sims) if r % 2 == 0 else list(sims)[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sims[key].run(150)
            torch.cuda.synchronize()
            walls[key].append(time.perf_counter() - t0)
    for s in sims.values():
        s.close()
    del sims, s
    torch.cuda.empty_cache()
    best = {k: min(v) for k, v in walls.items()}
    overhead = (best["telemetry"] - best["finite"]) / best["finite"]
    rec = {"health_ms": health_ms, "health_kernels": n_kernels,
           "health_kernel_ms": kernel_ms, "health_span_device_ms": span_ms,
           "health_and_readback_ms": readback_ms, "tb_step_ms": step_ms,
           "health_in_tb_steps": health_ms / step_ms,
           "run_150_walls_s": walls, "best_s": best,
           "telemetry_overhead": overhead,
           "health_pass_share": (best["finite"] - best["no_health"])
           / best["no_health"]}
    say(f"health pass cost: {json.dumps(rec)}")
    if not overhead <= TELEMETRY_OVERHEAD:
        fail(f"--telemetry costs {overhead:.2%} of the 150-step wall "
             f"(> {TELEMETRY_OVERHEAD:.0%})")
    return rec


def metrics_pass_cost(dev, size=256, reps=10):
    """Phase 29 (b): ``diag.metrics`` (the ``--metrics-every`` record) on
    the Mie example scaled to ``size``^3 (its eps sphere: the energy
    weights' box) after 20 steps: the device bytes it keeps (the box
    weights) and adds at its peak, and its CUDA-event ms."""
    import torch
    from fdtd3d_torch import diag
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(config(MIE, mie_args(size, 4)), device=dev)
    sim.advance(20)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    rec = diag.metrics(sim)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before
    added_peak = torch.cuda.max_memory_allocated() - before

    def fresh():
        sim._metrics_cache = None
        diag.metrics(sim)
    ms = timed(fresh, reps)
    out = {"size": size, "kept_bytes": kept, "added_peak_bytes": added_peak,
           "ms": ms, "energy": rec["energy"], "e_scale": rec["e_scale"]}
    del sim
    torch.cuda.empty_cache()
    say(f"metrics pass: {json.dumps(out)}")
    if not (rec["energy"] > 0 and added_peak <= HEALTH_PEAK_BYTES):
        fail(f"metrics pass: {out}")
    return out


def health_peak_1024(dev, steps=20):
    """Phase 29 (c): vacuum3D_tfsf at 1024^3 in f32 through
    ``Simulation`` for ``steps`` steps without the health pass (no sink,
    no finite check) and with ``--telemetry``: the peak device memory of
    each, the difference gated at ``HEALTH_PEAK_BYTES``."""
    import torch
    from fdtd3d_torch.sim import Simulation
    rec = {}
    for key, extra in (("without", []), ("with_telemetry", [
            "--telemetry", os.path.join(OBS_DIR, "t1024.jsonl")])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sim = Simulation(config(EXAMPLE, ["--same-size", "1024"] + extra),
                         device=dev)
        t0 = time.time()
        sim.advance(steps)
        torch.cuda.synchronize()
        wall = time.time() - t0
        rec[key] = {"peak_mem_bytes": torch.cuda.max_memory_allocated(),
                    "wall_s": wall, "step_kind": sim.step_kind}
        if key == "with_telemetry":
            # the pass's own transient above the carry it reads
            from fdtd3d_torch import telemetry
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            telemetry.readback(telemetry.make_health_fn(sim.static)(
                sim._dict_view()))
            rec["health_transient_bytes"] = \
                torch.cuda.max_memory_allocated() - base
        sim.close()
        del sim
    torch.cuda.empty_cache()
    recs = read_records(os.path.join(OBS_DIR, "t1024.jsonl"), "1024^3")
    rec["chunk"] = chunks_of(recs)[0]
    rec["added_peak_bytes"] = rec["with_telemetry"]["peak_mem_bytes"] \
        - rec["without"]["peak_mem_bytes"]
    say(f"health at 1024^3: {json.dumps(rec)}")
    if not rec["added_peak_bytes"] <= HEALTH_PEAK_BYTES \
            or not rec["chunk"]["finite"]:
        fail(f"1024^3: the health pass added "
             f"{rec['added_peak_bytes']} B of peak (> {HEALTH_PEAK_BYTES})")
    return rec


def supervised_telemetry(n=64, steps=240):
    """Phase 29 (d): the 64^3 dipole under ``--supervise
    --checkpoint-every 24`` with a NaN at t=168 and ``--telemetry``: one
    run_start/run_end pair, a rollback and a degrade record naming
    packed_tb_cuda -> packed_cuda, chip/host null, and the run_end's
    first_unhealthy_t bound (the first non-finite chunk)."""
    from fdtd3d_torch import faults
    out_dir = os.path.join(OBS_DIR, "supervised")
    shutil.rmtree(out_dir, ignore_errors=True)
    path = os.path.join(out_dir, "t.jsonl")
    argv = ["--3d", "--same-size", str(n), "--time-steps", str(steps),
            "--courant-factor", "0.5", "--wavelength", "12e-3",
            "--use-pml", "--pml-size", "8", "--point-source", "Ez",
            "--checkpoint-every", "24", "--supervise", "--save-dir",
            out_dir, "--telemetry", path]
    faults.clear()
    os.environ["FDTD3D_FAULT_PLAN"] = "nan@t=168"
    try:
        _out, _err, launches, wall, _peak = cli_logged(
            argv, "supervised dipole with telemetry")
    finally:
        os.environ.pop("FDTD3D_FAULT_PLAN")
        faults.clear()
    recs = read_records(path, "supervised dipole")
    types = [r["type"] for r in recs]
    deg = [(r["old_kind"], r["new_kind"]) for r in recs
           if r["type"] == "degrade"]
    rb = [(r["t_failed"], r["t_restored"]) for r in recs
          if r["type"] == "rollback"]
    bad = [r["t"] for r in chunks_of(recs) if not r["finite"]]
    rec = {"wall_s": wall, "records": len(recs), "degrades": deg,
           "rollbacks": rb, "nonfinite_chunks": bad,
           "first_unhealthy_t": recs[-1].get("first_unhealthy_t"),
           "launches": {k: launches[k] for k in ("tb_pass", "e_update",
                                                 "h_update")}}
    say(f"supervised dipole telemetry: {json.dumps(rec)}")
    if types.count("run_start") != 1 or types.count("run_end") != 1 \
            or types[-1] != "run_end" \
            or deg != [("packed_tb_cuda", "packed_cuda")] \
            or rb != [(192, 168)] or bad != [192] \
            or rec["first_unhealthy_t"] != 192 or not all(
                r["chip"] is None and r["host"] is None for r in recs
                if r["type"] in ("rollback", "degrade")):
        fail(f"supervised dipole telemetry: {rec}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def batch_telemetry(dev, size=128, steps=41, chunk=10, bad_lane=1):
    """Phase 29 (e): 3 Mie lanes at ``size``^3 (eps-sphere 2, 4, 6)
    through the CLI's ``--batch --telemetry --per-chip-telemetry`` in
    chunks of ``chunk`` (the last one step: the lane-capable packed
    tail), a NaN written into lane ``bad_lane`` after the first chunk:
    the lane-capable tb and packed kernels, one batch_lane and one
    per_chip row a lane a chunk, only that lane non-finite (from the
    second chunk on), and each lane's counters against the same lane run
    solo (``Simulation``, same chunks; the bad lane up to its NaN)."""
    from fdtd3d_torch import batch as batch_mod
    from fdtd3d_torch import telemetry
    from fdtd3d_torch.sim import Simulation
    out_dir = os.path.join(OBS_DIR, "batch")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    path = os.path.join(out_dir, "t.jsonl")
    lane_flags = [mie_args(size, eps, ["--time-steps", str(steps)])
                  for eps in (2, 4, 6)]
    files = []
    for i, flags in enumerate(lane_flags):
        p = os.path.join(out_dir, f"lane{i}.txt")
        with open(MIE) as f:
            body = f.read()
        with open(p, "w") as f:
            f.write(f"{body}\n{' '.join(flags)}\n")
        files.append(p)
    real = batch_mod.BatchSimulation.advance

    def advance(bsim, n):
        real(bsim, n)
        if bsim.t == chunk:
            bsim._dict_view()["E"]["Ez"][bad_lane, size // 2, size // 2,
                                         size // 2] = float("nan")
        return bsim

    batch_mod.BatchSimulation.advance = advance
    try:
        out, _err, launches, wall, peak = cli_logged(
            ["--batch", *files, "--batch-chunk", str(chunk),
             "--telemetry", path, "--per-chip-telemetry"],
            "batch with telemetry")
    finally:
        batch_mod.BatchSimulation.advance = real
    passes, tails = tb_launches(steps, chunk)
    if "step_kind=packed_tb_cuda" not in out or (
            launches["tb_pass"], launches["e_update"],
            launches["h_update"]) != (passes, tails, tails):
        fail(f"batch telemetry: not the lane-capable tb pass and its "
             f"packed tail ({launches})")
    recs = read_records(path, "batch")
    if recs[0].get("batch") != 3 or "batch_fallback" in recs[0]:
        fail(f"batch telemetry: run_start {recs[0]}")
    rows = [r for r in recs if r["type"] == "batch_lane"]
    per = [r for r in recs if r["type"] == "per_chip"]
    ts = list(range(chunk, steps + 1, chunk)) \
        + ([steps] if steps % chunk else [])
    if [(r["t"], r["lane"]) for r in rows] != [(t, ln) for t in ts
                                               for ln in range(3)] \
            or [(r["t"], r["lane"]) for r in per] != \
            [(r["t"], r["lane"]) for r in rows]:
        fail(f"batch telemetry: rows {[(r['t'], r['lane']) for r in rows]}")
    for r in rows:
        want = r["lane"] != bad_lane or r["t"] == chunk
        if r["finite"] != want:
            fail(f"batch telemetry: lane {r['lane']} at t={r['t']} "
                 f"finite={r['finite']}")
    errs = {}
    dx = config(MIE, lane_flags[0]).dx
    for lane, flags in enumerate(lane_flags):
        solo = Simulation(config(MIE, flags), device=dev)
        hfn = telemetry.make_health_fn(solo.static)
        for t in ts:
            solo.advance(t - solo.t)
            row = next(r for r in rows if r["t"] == t and r["lane"] == lane)
            if not row["finite"]:
                continue
            want = telemetry.readback(hfn(solo._dict_view()))
            e = counters_close(row, want, HEALTH_MAX_REL,
                               HEALTH_ENERGY_REL,
                               HEALTH_DIV_ABS * want["max_e"] / dx,
                               f"batch lane {lane} t={t} vs solo")
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
        del solo, hfn
    rec = {"lanes": 3, "size": size, "steps": steps, "chunk": chunk,
           "bad_lane": bad_lane, "wall_s": wall, "peak_mem_bytes": peak,
           "launches": {k: launches[k] for k in ("tb_pass", "e_update",
                                                 "h_update")},
           "rows": len(rows),
           "vs_solo_rel_or_gate_share": errs,
           "lane_lines": [ln for ln in out.splitlines()
                          if ln.startswith("batch lane ")]}
    say(f"batch telemetry: {json.dumps(rec)}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def trace_run(n=64, steps=20):
    """Phase 29 (f): ``--trace DIR --telemetry`` on a 64^3 dipole on the
    tb pass: DIR/trace.json holds the chunk, readback and health spans
    and device kernels."""
    from fdtd3d_torch import profiling
    out_dir = os.path.join(OBS_DIR, "trace")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--3d", "--same-size", str(n), "--time-steps", str(steps),
            "--courant-factor", "0.5", "--wavelength", "12e-3",
            "--use-pml", "--pml-size", "8", "--point-source", "Ez",
            "--norms-every", "10", "--save-dir", out_dir, "--telemetry",
            os.path.join(out_dir, "t.jsonl"), "--trace",
            os.path.join(out_dir, "trace")]
    _out, _err, launches, wall, _peak = cli_logged(argv, "trace")
    tpath = os.path.join(out_dir, "trace", profiling.TRACE_FILE)
    if not os.path.exists(tpath):
        fail(f"trace: no {tpath}")
    with open(tpath) as f:
        events = json.load(f)["traceEvents"]
    names = {}
    kernels = 0
    for ev in events:
        nm = ev.get("name", "")
        if nm.startswith("fdtd3d/"):
            names[nm] = names.get(nm, 0) + 1
        if ev.get("cat") == "kernel":
            kernels += 1
    rec = {"n": n, "steps": steps, "wall_s": wall,
           "bytes": os.path.getsize(tpath), "spans": names,
           "device_kernels": kernels, "tb_pass": launches["tb_pass"]}
    say(f"trace: {json.dumps(rec)}")
    if not all(s in names for s in TRACE_SPANS) or kernels == 0 \
            or launches["tb_pass"] != steps // 2:
        fail(f"trace: spans or kernels missing: {rec}")
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def observability(dev):
    """Phase 29: the health counters, the telemetry sink and profiling on
    the main path, the supervisor and the batch."""
    shutil.rmtree(OBS_DIR, ignore_errors=True)   # sinks append
    rec = {"main_path": health_counters_main_path(dev),
           "cost": health_pass_cost(dev),
           "metrics_pass": metrics_pass_cost(dev),
           "peak_1024": health_peak_1024(dev),
           "supervised": supervised_telemetry(),
           "batch": batch_telemetry(dev),
           "trace": trace_run()}
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    return rec


# --------------------------------------------------------------------------
# complex field values: the paired real legs on the packed twin (phase 30)
# --------------------------------------------------------------------------

COMPLEX_DIR = os.path.join(OUT_DIR, "complex")
COMPLEX = ["--complex-field-values"]
# phase 30 (d): the complex dipole's far-field pattern against the real
# run's (the re leg is the real run, the im leg stays 0)
COMPLEX_PATTERN_TOL = 1e-6


def complex_parts(state):
    """(real parts, imaginary parts) of a complex dict-form state, as two
    trees of contiguous real tensors."""
    from fdtd3d_torch.solver import _complex_parts
    import torch
    return _complex_parts(state, torch.real), _complex_parts(state,
                                                             torch.imag)


def seed_legs(sim, dev, seed):
    """Seeded 0.01 N(0, 1) E, H and J/K in both legs of a paired
    complex sim's carry (a different draw for each leg)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    for part in ("re", "im"):
        carry = sim._carry[part]
        for key in ("E", "H", "J", "K"):
            if key in carry:
                carry[key].copy_(0.01 * torch.randn(
                    carry[key].shape, generator=g, device=dev))


def paired_vs_plain(cfg, dev, seed, label, steps=STEPS_CMP):
    """One paired step (both legs on the CUDA kernels) and then
    ``steps`` against the native-complex plain step on the card from the
    same seeded complex state, the real and the imaginary parts of every
    leaf (E, H, psi, J/K, the incident line) gated at ``TOL`` of their
    family's max; -> (worst error, the sim's kind)."""
    import torch
    from fdtd3d_torch.sim import Simulation
    from fdtd3d_torch.solver import build_static, make_plain_step
    sim = Simulation(cfg, device=dev)
    if sim.step_kind not in ("complex2x_packed_cuda",):
        fail(f"{label}: ran {sim.step_kind}, not complex2x_packed_cuda")
    seed_legs(sim, dev, seed)
    native = build_static(cfg)        # no device: the native route
    plain = make_plain_step(native)
    want = sim.state                  # the joined complex state (copies)
    step = sim._runner
    worst = 0.0
    for n in (1, steps):
        sim.advance(n)
        for _ in range(n):
            want = plain(want, sim.coeffs)
        torch.cuda.synchronize()
        got = sim._dict_view()
        for part, g, w in zip(("re", "im"), complex_parts(got),
                              complex_parts(want)):
            worst = max(worst, compare(g, w, f"{label}: {n} step(s), {part}",
                                       family=True))
        del got
    say(f"{label}: the paired legs ({step.kind}) match the native complex "
        f"plain step over 1 + {steps} steps (max abs err {worst:.3e})")
    del sim, want
    torch.cuda.empty_cache()
    return worst


def complex_kernels(dev):
    """Phase 30 (a): the paired legs against the native complex plain
    step at 256^3 (vacuum3D_tfsf, BASELINE config #3's full width), at
    128^3 with an eps sphere and a Drude sphere (grids, J) and with a
    double-negative sphere (K)."""
    mie = ["--same-size", "128", "--eps-sphere-center-x", "64",
           "--eps-sphere-center-y", "64", "--eps-sphere-center-z", "64",
           "--eps-sphere-radius", "16", "--use-drude", "--eps-inf", "4.0",
           "--omega-p", "1e12", "--gamma-d", "5e10",
           "--drude-sphere-center-x", "64", "--drude-sphere-center-y",
           "64", "--drude-sphere-center-z", "64",
           "--drude-sphere-radius", "12", "--topology", "none"]
    return {
        "vacuum_256": paired_vs_plain(
            config(EXAMPLE, ["--same-size", "256"] + COMPLEX), dev, 71,
            "complex 256^3 TFSF+CPML"),
        "mie_128": paired_vs_plain(
            config(MIE, mie + COMPLEX), dev, 72,
            "complex 128^3 eps sphere + Drude sphere"),
        "dng_128": paired_vs_plain(
            config(MIE, dng_flags(128, 10) + COMPLEX), dev, 73,
            "complex 128^3 double-negative sphere (J and K)")}


def complex_main_path(steps=150):
    """Phase 30 (b): vacuum3D_tfsf at 256^3, ``steps`` steps, complex,
    through the CLI with DAT dumps, ``--check-finite`` and
    ``--telemetry``: the kind and token, 2 x ``steps`` packed launches a
    family and no tb pass, finite ``<c8`` dumps, one run_start/run_end;
    then the same argv real under ``FDTD3D_NO_TEMPORAL``: the re parts
    bit-equal to its dumps, the im parts exactly 0."""
    import numpy as np
    from fdtd3d_torch import telemetry
    from fdtd3d_torch.io import load_dat
    dirs = {k: os.path.join(COMPLEX_DIR, f"main_{k}")
            for k in ("complex", "real")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    tel = os.path.join(dirs["complex"], "t.jsonl")
    base = ["--cmd-from-file", EXAMPLE, "--same-size", "256",
            "--time-steps", str(steps), "--save-res", str(steps),
            "--check-finite"]
    log, _err, launches, wall, peak = cli_logged(
        base + COMPLEX + ["--telemetry", tel, "--save-dir",
                          dirs["complex"]], "complex main path")
    want = dict({k: 0 for k in launches}, e_update=2 * steps,
                h_update=2 * steps)
    got = dict(launches)
    if got != want:
        fail(f"complex main path: launches {got} != {want}")
    if "step_kind=complex2x_packed_cuda tb_fallback=paired_complex" \
            not in log:
        fail("complex main path: not complex2x_packed_cuda with the "
             "paired_complex token")
    recs = telemetry.read_jsonl(tel)      # every record validated
    types = [r.get("type") for r in recs]
    if types.count("run_start") != 1 or types.count("run_end") != 1:
        fail(f"complex main path: records {types}")
    os.environ["FDTD3D_NO_TEMPORAL"] = "1"
    try:
        rlog, _e, rlaunches, rwall, rpeak = cli_logged(
            base + ["--save-dir", dirs["real"]], "real, FDTD3D_NO_TEMPORAL")
    finally:
        os.environ.pop("FDTD3D_NO_TEMPORAL")
    if "step_kind=packed_cuda" not in rlog:
        fail("the real run under FDTD3D_NO_TEMPORAL is not packed_cuda")
    re_equal, im_zero = True, True
    for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        name = f"{c}_t{steps:06d}.dat"
        z = load_dat(os.path.join(dirs["complex"], name))
        r = load_dat(os.path.join(dirs["real"], name))
        with open(os.path.join(dirs["complex"], name + ".manifest.json")) \
                as f:
            dtype = json.load(f)["dtype"]
        if z.shape != (256, 256, 256) or dtype != "<c8" \
                or not np.isfinite(z).all():
            fail(f"{c}: bad complex dump ({z.shape}, {dtype}, or "
                 f"non-finite)")
        re_equal &= bool(np.array_equal(z.real.view(np.uint32),
                                        r.view(np.uint32)))
        im_zero &= not bool(np.any(z.imag))
    rec = {"steps": steps, "launches": got, "wall_s": wall,
           "mcells_per_s": done_mcps(log), "peak_mem_bytes": peak,
           "real_wall_s": rwall, "real_mcells_per_s": done_mcps(rlog),
           "real_peak_mem_bytes": rpeak,
           "real_launches": {k: rlaunches[k]
                             for k in ("tb_pass", "e_update", "h_update")},
           "re_bit_equal_to_real": re_equal, "im_exactly_zero": im_zero,
           "records": len(recs)}
    say(f"complex main path: {json.dumps(rec)}")
    if not (re_equal and im_zero):
        fail(f"complex main path: superposition gate failed (re bit-equal "
             f"{re_equal}, im zero {im_zero})")
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    return rec


def complex_times(dev, reps=50, plain_reps=3):
    """Phase 30 (c): at 256^3 in one call, CUDA-event ms of the paired
    step (its two legs' launches and patches), of the real packed step
    (the leg's own configuration) and of the real tb step (a pass / 2),
    of pack and unpack, and of each packed launch on a leg beside its
    plain version and bound (the ``kernels`` line's complex rows); then
    peak device memory of 20 complex and 20 real steps at 256^3 and 512^3
    (vacuum3D_tfsf), with set-up seconds and Mcells/s."""
    import gc

    import torch
    from fdtd3d_torch.ops import packed, packed_tb
    from fdtd3d_torch.sim import Simulation
    from fdtd3d_torch.solver import build_static, make_step
    cfg = config(EXAMPLE, ["--same-size", "256"] + COMPLEX)
    sim = Simulation(cfg, device=dev)
    sim.advance(150)                    # a wave on the grid
    pstep = make_step(sim.static, dev)
    pcc = pstep.prepare(sim.coeffs)
    carry = sim._carry
    paired_ms = timed(lambda: pstep(carry, pcc), reps)
    state = sim.state
    pack_ms = timed(lambda: pstep.pack(state), 5)
    unpack_ms = timed(lambda: pstep.unpack(carry), 5)
    del state
    leg = carry["re"]
    cc = pcc["re"]
    e_ms = timed(lambda: packed.e_update(leg["E"], leg["H"], leg.get("J"),
                                         leg["psE"], cc["E"]), reps)
    h_ms = timed(lambda: packed.h_update(leg["H"], leg["E"], leg["psH"],
                                         cc["H"]), reps)
    e_plain = timed(lambda: packed.e_update_plain(
        leg["E"], leg["H"], leg.get("J"), leg["psE"], cc["E"]), plain_reps)
    h_plain = timed(lambda: packed.h_update_plain(
        leg["H"], leg["E"], leg["psH"], cc["H"]), plain_reps)
    bound = {}
    for fam in ("E", "H"):
        t_bytes = family_bytes(leg, cc, fam) / HBM_BYTES_PER_S * 1e3
        t_ops = family_flops(leg, fam) / F32_FLOPS * 1e3
        bound[fam] = (max(t_bytes, t_ops),
                      "bytes" if t_bytes >= t_ops else "operations")
    real = build_static(config(EXAMPLE, ["--same-size", "256"]))
    rstep = packed.make_packed_step(real, dev)
    rcc = rstep.prepare(sim.coeffs)
    packed_ms = timed(lambda: rstep(leg, rcc), reps)
    tb = packed_tb.make_packed_tb_step(real, dev)
    tcc = tb.prepare(sim.coeffs)
    tb_carry = {k: clone_carry(v) for k, v in leg.items()}
    tb_ms = timed(lambda: tb(tb_carry, tcc), reps) / 2
    del tb_carry, tb, tcc, rstep, rcc, pstep, pcc, leg, cc, carry, sim
    cells = 256 ** 3
    rec = {"paired_step_ms": paired_ms, "real_packed_step_ms": packed_ms,
           "real_tb_step_ms": tb_ms, "pack_ms": pack_ms,
           "unpack_ms": unpack_ms,
           "paired_over_packed": paired_ms / packed_ms,
           "paired_over_tb": paired_ms / tb_ms,
           "mcells_per_s": cells / (paired_ms * 1e-3) / 1e6,
           "e_update_ms": e_ms, "h_update_ms": h_ms,
           "e_plain_ms": e_plain, "h_plain_ms": h_plain,
           "e_bound_ms": bound["E"][0], "e_bound_by": bound["E"][1],
           "h_bound_ms": bound["H"][0], "h_bound_by": bound["H"][1]}
    say(f"complex times at 256^3: {json.dumps(rec)}")
    for size in (256, 512):
        for label, extra in (("complex", COMPLEX), ("real", [])):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.time()
            s = Simulation(config(EXAMPLE, ["--same-size", str(size),
                                            "--check-finite"] + extra),
                           device=dev)
            s.advance(2)
            torch.cuda.synchronize()
            setup = time.time() - t0
            t0 = time.time()
            s.advance(20)
            torch.cuda.synchronize()
            wall = time.time() - t0
            r = {"step_kind": s.step_kind, "setup_s": setup, "wall_s": wall,
                 "mcells_per_s": size ** 3 * 20 / wall / 1e6,
                 "peak_mem_bytes": torch.cuda.max_memory_allocated()}
            rec[f"{label}_{size}"] = r
            say(f"{label} {size}^3, 20 steps: {json.dumps(r)}")
            del s
    for size in (256, 512):
        rec[f"peak_ratio_{size}"] = rec[f"complex_{size}"][
            "peak_mem_bytes"] / rec[f"real_{size}"]["peak_mem_bytes"]
    torch.cuda.empty_cache()
    return rec


def complex_dipole(n=64, steps=240):
    """Phase 30 (d): the 64^3 z dipole complex with ``--ntff``: the
    pattern within ``COMPLEX_PATTERN_TOL`` of the real run's (under
    ``FDTD3D_NO_TEMPORAL``: the same packed kernels), the im leg 0 at
    the end; then ``--supervise`` with a NaN at t=168: one rollback and
    one degrade, complex kinds on both rungs."""
    import numpy as np
    import torch
    from fdtd3d_torch import faults
    base = ["--3d", "--same-size", str(n), "--time-steps", str(steps),
            "--courant-factor", "0.5", "--wavelength", "12e-3",
            "--use-pml", "--pml-size", "8", "--point-source", "Ez",
            "--ntff", "--ntff-margin", "8", "--checkpoint-every", "24"]
    cfg = config(os.devnull, base)
    dirs = {k: os.path.join(COMPLEX_DIR, f"dipole_{k}")
            for k in ("complex", "real", "supervised")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    with NtffProbe() as probe:
        log, _e, launches, wall, _p = cli_logged(
            base + COMPLEX + ["--save-dir", dirs["complex"]],
            "complex dipole")
    legs = probe.col.sim.component_legs()
    im_zero = all(not bool(torch.any(v)) for v in legs[1].values())
    probe.col = None
    del legs
    os.environ["FDTD3D_NO_TEMPORAL"] = "1"
    try:
        cli_logged(base + ["--save-dir", dirs["real"]], "real dipole")
    finally:
        os.environ.pop("FDTD3D_NO_TEMPORAL")
    rel = float(np.abs(read_pattern(dirs["complex"], cfg, "complex dipole")
                       - read_pattern(dirs["real"], cfg, "real dipole"))
                .max())
    faults.clear()
    os.environ["FDTD3D_FAULT_PLAN"] = "nan@t=168"
    try:
        slog, serr, slaunches, swall, _p = cli_logged(
            base + COMPLEX + ["--supervise", "--save-dir",
                              dirs["supervised"]], "complex dipole supervised")
    finally:
        os.environ.pop("FDTD3D_FAULT_PLAN")
        faults.clear()
    rungs = [ln.split("degraded ")[1].split(" -> ") for ln in
             serr.splitlines() if "degraded " in ln]
    rec = {"n": n, "steps": steps, "wall_s": wall,
           "launches": {k: launches[k] for k in ("tb_pass", "e_update",
                                                  "h_update")},
           "pattern_rel_vs_real": rel, "im_leg_zero": im_zero,
           "supervised_wall_s": swall, "degrades": rungs,
           "supervised_launches": {k: v for k, v in slaunches.items()
                                   if k in ("e_update", "h_update",
                                            "fused_eh", "e_family",
                                            "h_family", "tb_pass")}}
    say(f"complex dipole: {json.dumps(rec)}")
    if "step_kind=complex2x_packed_cuda" not in log or not im_zero:
        fail(f"complex dipole: not complex2x_packed_cuda, or the im leg "
             f"is not 0 ({im_zero})")
    if not rel <= COMPLEX_PATTERN_TOL:
        fail(f"complex dipole: pattern {rel:.3e} from the real run's")
    if "1 rollbacks, 1 ladder degrades (now complex2x_" not in slog \
            or len(rungs) != 1 \
            or not all(r.strip().startswith("complex2x_") and
                       r.strip().endswith("_cuda") for r in rungs[0]):
        fail(f"complex dipole supervised: {rungs}, {slog[-300:]}")
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    return rec


def complex_fields(dev):
    """Phase 30: complex field values as paired real legs on the packed
    twin: kernels against the native complex plain step, the CLI main
    path and its superposition gate, the times and peak memory, the
    complex dipole's far field and a supervised NaN."""
    shutil.rmtree(COMPLEX_DIR, ignore_errors=True)
    rec = {"max_abs_err": complex_kernels(dev),
           "main_path": complex_main_path(),
           "times": complex_times(dev),
           "dipole": complex_dipole()}
    shutil.rmtree(COMPLEX_DIR, ignore_errors=True)
    return rec



# --------------------------------------------------------------------------
# float32x2 with magnetic Drude K, and complex float32x2 (phase 31)
# --------------------------------------------------------------------------

X2 = ["--dtype", "float32x2"]
DS_K_DIR = os.path.join(OUT_DIR, "ds_k")
# the float32x2 bar with the deliberately plain-f32 ADE currents J and K
# (fdtd3d_tpu/solver.py:939-961); DS_REL_BAR is the vacuum example's
DS_ADE_BAR = 1e-6


def k_sphere_flags(size):
    """A K sphere alone (tests/torch_parity.py's materials: mu_inf 1.5,
    omega_pm 1e11, gamma_m 1e10) on the precision example at ``size``
    (oblique TFSF, CPML), radius size/8."""
    c, r = str(size // 2), str(size // 8)
    out = ["--same-size", str(size), "--use-drude-m", "--mu-inf", "1.5",
           "--omega-pm", "1e11", "--gamma-m", "1e10"]
    for a in "xyz":
        out += [f"--drude-m-sphere-center-{a}", c]
    return out + ["--drude-m-sphere-radius", r]


def ds_k_kernels(dev):
    """Phase 31 (a): 10 CUDA ds steps with K against 10 of the plain
    version (the reference's schedule in torch ops) from one seeded
    carry (E/H pairs, J, K) at 128^3: the DNG sphere of ``dng_flags``
    (J and K on one sphere, da/db pair grids, km/bm in their box) and a
    K sphere alone on the precision example (oblique TFSF); fields at
    DS_FIELD_TOL of their family's max, J and K at DS_J_TOL."""
    return {
        "dng_128": ds_kernel_vs_plain(
            config(MIE, dng_flags(128, 10) + X2), dev, 81,
            "ds 128^3 DNG sphere (J and K)"),
        "k_sphere_128": ds_kernel_vs_plain(
            config(PRECISION, k_sphere_flags(128)), dev, 82,
            "ds 128^3 K sphere, oblique TFSF")}


def ds_k_accuracy(dev, steps=300):
    """Phase 31 (b): the DNG sphere at 128^3 for ``steps`` steps through
    ``Simulation``: float32x2 (the K kernel) and float32 (the packed K
    build) against the port's float64 plain step on the card, each
    field's max |diff| over its family's f64 max; float32x2 gated at
    DS_ADE_BAR."""
    import numpy as np
    from fdtd3d_torch.sim import Simulation
    runs = {}
    for dtype, kind in (("float64", "plain"), ("float32x2", "packed_ds_cuda"),
                        ("float32", "packed_cuda")):
        sim = Simulation(config(MIE, dng_flags(128, steps)
                                + ["--dtype", dtype]), device=dev)
        if sim.step_kind != kind:
            fail(f"DNG 128^3 {dtype} ran {sim.step_kind}, not {kind}")
        sim.run()
        sim.block_until_ready()
        runs[dtype] = sim.fields()
        del sim
    ref = runs.pop("float64")
    rec = {"steps": steps, "e_max": float(max(np.abs(ref[c]).max()
                                              for c in ref if c[0] == "E")),
           "rel_vs_f64": rel_vs_f64(runs["float32x2"], ref),
           "f32_rel_vs_f64": rel_vs_f64(runs["float32"], ref)}
    say(f"DNG 128^3 accuracy: {json.dumps(rec)}")
    if not rec["e_max"] > 0:
        fail("DNG 128^3: no wave reached the grid")
    if not rec["rel_vs_f64"] <= DS_ADE_BAR:
        fail(f"DNG 128^3 float32x2 rel vs f64 {rec['rel_vs_f64']:.3e} > "
             f"{DS_ADE_BAR}")
    return rec


def ds_k_times(dev, size=256, steps=40, reps=20, plain_reps=2):
    """Phase 31 (c): the DNG sphere at ``size``^3 in float32x2 through
    ``Simulation`` for ``steps`` steps with the finite check (the main
    path: ds launches, kernels a step, set-up, peak memory), then on
    its state, 100 steps in, one CUDA step against the plain version
    from a seeded copy (E/H pairs, J, K everywhere: ``seed_ds_carry``;
    fields at DS_FIELD_TOL, J and K at DS_J_TOL), the shape and plan the
    times are taken at, and CUDA-event times of the line, the pass and
    the step beside the plain version and the bound (``ds_times``: K's
    24 B/cell, every coefficient grid inside its box); then the same
    without K (J only, mu a scalar) in the same call."""
    import torch
    from fdtd3d_torch.ops import packed_ds
    from fdtd3d_torch.sim import Simulation
    rec = {"steps": steps}
    for label, flags in (("k", dng_flags(size, steps)),
                         ("no_k", dng_flags(size, steps)[:-3])):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        sim = Simulation(config(MIE, flags + X2 + ["--check-finite"]),
                         device=dev)
        setup = time.time() - t0
        if sim.step_kind != "packed_ds_cuda" \
                or sim.static.use_drude_m != (label == "k"):
            fail(f"DNG {size}^3 {label}: {sim.step_kind}, use_drude_m "
                 f"{sim.static.use_drude_m}")
        if label == "k":
            reset_launches()
            t0 = time.time()
            sim.run()
            sim.block_until_ready()
            got = {"ds_pass": packed_ds.ds_pass.launches,
                   "ds_line": packed_ds.line_advance.launches}
            if got != {"ds_pass": steps, "ds_line": steps}:
                fail(f"DNG {size}^3 float32x2: launches {got}")
            rec.update(launches=got, wall_s=time.time() - t0, setup_s=setup,
                       kernels_per_step=(got["ds_line"]
                                         + packed_ds.ds_pass.kernels) / steps,
                       peak_mem_bytes=torch.cuda.max_memory_allocated())
            if rec["kernels_per_step"] > 3:
                fail(f"DNG {size}^3: {rec['kernels_per_step']} kernels a "
                     f"step")
        sim.advance(100 - sim.t)          # the line carries the wave
        err = ds_one_step_vs_plain(
            sim, seed=83, what=f"DNG {size}^3 {label}: one seeded ds step")
        rec[label] = ds_times(sim, dev, reps, plain_reps)
        rec[label]["max_abs_err"] = err
        del sim
    torch.cuda.empty_cache()
    rec["k_over_no_k"] = rec["k"]["pass_ms"] / rec["no_k"]["pass_ms"]
    say(f"DNG {size}^3 ds times: {json.dumps(rec)}")
    return rec


def complex_ds_main_path(dev, real_fields=None, ref64=None):
    """Phase 31 (d): the precision example as it stands (128^3, 1000
    steps) with ``--complex-field-values --telemetry``: the kind and
    token, 2 x the real run's ds launches, ``<c8`` dumps whose re parts
    are bit-equal to the real float32x2 run's dumps and whose im parts
    are exactly 0, and their accuracy against a float64 complex run
    (DS_REL_BAR); ``real_fields``/``ref64``: phase 5's real float32x2
    dumps and float64 fields of the same configuration, when the whole
    script has them."""
    import numpy as np
    from fdtd3d_torch import telemetry
    from fdtd3d_torch.io import load_dat
    from fdtd3d_torch.sim import Simulation
    steps = config(PRECISION, []).time_steps
    dirs = {k: os.path.join(DS_K_DIR, f"complex_{k}")
            for k in ("complex", "real")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    tel = os.path.join(dirs["complex"], "t.jsonl")
    base = ["--cmd-from-file", PRECISION, "--save-res", str(steps),
            "--check-finite"]
    log, _e, launches, wall, peak = cli_logged(
        base + COMPLEX + ["--telemetry", tel, "--save-dir",
                          dirs["complex"]], "complex float32x2")
    if "step_kind=complex2x_packed_ds_cuda tb_fallback=paired_complex" \
            not in log:
        fail("complex float32x2: not complex2x_packed_ds_cuda with the "
             "paired_complex token")
    recs = telemetry.read_jsonl(tel)
    rec = {"steps": steps, "wall_s": wall, "peak_mem_bytes": peak,
           "launches": {k: launches[k] for k in ("ds_pass", "ds_line")},
           "records": len(recs)}
    if real_fields is None:
        rlog, _e, rl, rwall, rpeak = cli_logged(
            base + ["--save-dir", dirs["real"]], "real float32x2")
        rec.update(real_wall_s=rwall, real_peak_mem_bytes=rpeak,
                   real_launches={k: rl[k] for k in ("ds_pass", "ds_line")})
        real_fields = {c: load_dat(os.path.join(
            dirs["real"], f"{c}_t{steps:06d}.dat"))
            for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz")}
    want = {"ds_pass": 2 * steps, "ds_line": 2 * steps}
    if rec["launches"] != want or any(
            launches[k] for k in ("tb_pass", "e_update", "h_update")):
        fail(f"complex float32x2: launches {launches} != {want}")
    re_equal, im_zero, fields = True, True, {}
    for c, r in real_fields.items():
        name = f"{c}_t{steps:06d}.dat"
        z = load_dat(os.path.join(dirs["complex"], name))
        with open(os.path.join(dirs["complex"], name + ".manifest.json")) \
                as f:
            dtype = json.load(f)["dtype"]
        if dtype != "<c8" or z.shape != r.shape or not np.isfinite(z).all():
            fail(f"complex float32x2 {c}: {dtype} {z.shape}")
        re_equal &= bool(np.array_equal(z.real.view(np.uint32),
                                        np.asarray(r).view(np.uint32)))
        im_zero &= not bool(np.any(z.imag))
        fields[c] = z
    if ref64 is None:
        sim = Simulation(config(PRECISION, COMPLEX + ["--dtype",
                                                      "float64"]),
                         device=dev)
        sim.run()
        ref64 = sim.fields()
        del sim
    rel = rel_vs_f64(fields, ref64)
    rec.update(re_bit_equal_to_real=re_equal, im_exactly_zero=im_zero,
               rel_vs_f64=rel)
    say(f"complex float32x2 main path: {json.dumps(rec)}")
    if not (re_equal and im_zero):
        fail(f"complex float32x2: re bit-equal {re_equal}, im zero "
             f"{im_zero}")
    if not rel <= DS_REL_BAR:
        fail(f"complex float32x2 rel vs f64 {rel:.3e} > {DS_REL_BAR}")
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)
    return rec


def paired_ds_vs_plain(sim, pstep, pcc, seed):
    """One paired complex step of the kernels against each leg's plain
    ds step, from a copy of ``sim``'s carry with both legs' E/H pairs
    seeded (``seed_ds_carry``, a seed a leg): the re leg against the
    plain step of the real configuration, the im leg against that of
    the configuration with its TFSF and point-source amplitudes zeroed
    (the reference's im leg); the reference's packed-ds gates on each
    leg, and the im leg must come out nonzero. Returns the worst errors
    over both legs (``compare_ds``)."""
    import dataclasses

    import torch
    from fdtd3d_torch.ops import packed_ds
    from fdtd3d_torch.solver import build_static
    cfg_re = dataclasses.replace(sim.static.cfg, complex_fields=False)
    cfg_im = dataclasses.replace(
        cfg_re, point_source=dataclasses.replace(cfg_re.point_source,
                                                 amplitude=0.0),
        tfsf=dataclasses.replace(cfg_re.tfsf, amplitude=0.0))
    start = clone_carry(sim._carry)
    for i, part in enumerate(("re", "im")):
        seed_ds_carry(start[part], sim.device, seed + i)
    got = pstep(clone_carry(start), pcc)
    worst = {"pass": 0.0, "line": 0.0}
    for part, cfg in (("re", cfg_re), ("im", cfg_im)):
        plain = packed_ds.make_packed_ds_step(build_static(cfg), sim.device,
                                              plain=True)
        want = plain(start[part], pcc[part])
        torch.cuda.synchronize()
        err = compare_ds(got[part], want, f"complex float32x2 {part} leg: "
                         "one seeded paired step", DS_FIELD_TOL)
        worst = {k: max(worst[k], err[k]) for k in worst}
    if not float(got["im"]["E"][:3].abs().max()) > 0:
        fail("complex float32x2: the seeded im leg came out zero")
    say(f"complex float32x2: one seeded paired step matches each leg's "
        f"plain ds step (max abs err {max(worst.values()):.3e})")
    return worst


def complex_ds_times(dev, reps=50, plain_reps=3):
    """Phase 31 (d): at 128^3 (the precision example, a wave on the grid)
    one seeded paired step against each leg's plain step
    (``paired_ds_vs_plain``), CUDA-event ms of the paired step beside
    the real ds step in the same call, of pack and unpack; one leg's
    line and pass beside their plain versions and bounds (``ds_times``
    on the re leg)."""
    import types

    from fdtd3d_torch.ops import packed_ds
    from fdtd3d_torch.sim import Simulation
    from fdtd3d_torch.solver import build_static, make_step
    sim = Simulation(config(PRECISION, COMPLEX), device=dev)
    sim.advance(100)
    pstep = make_step(sim.static, dev)
    pcc = pstep.prepare(sim.coeffs)
    carry = sim._carry
    err = paired_ds_vs_plain(sim, pstep, pcc, seed=84)
    leg = types.SimpleNamespace(static=build_static(config(PRECISION, [])),
                                _carry=carry["re"], coeffs=sim.coeffs,
                                device=dev)
    paired_ms = timed(lambda: pstep(carry, pcc), reps)
    rstep = packed_ds.make_packed_ds_step(leg.static, dev)
    rcc = rstep.prepare(sim.coeffs)
    real = clone_carry(carry["re"])
    real_ms = timed(lambda: rstep(real, rcc), reps)
    state = sim.state
    pack_ms = timed(lambda: pstep.pack(state), 5)
    unpack_ms = timed(lambda: pstep.unpack(carry), 5)
    del state, real
    leg_t = ds_times(leg, dev, reps, plain_reps)
    rec = {"paired_step_ms": paired_ms, "real_ds_step_ms": real_ms,
           "paired_over_real": paired_ms / real_ms, "pack_ms": pack_ms,
           "unpack_ms": unpack_ms, "leg": leg_t, "max_abs_err": err}
    say(f"complex float32x2 times at 128^3: {json.dumps(rec)}")
    return rec


def complex_ds_supervised(n=64, steps=60):
    """Phase 31 (d): the precision example at ``n``^3, complex, under
    ``--supervise`` with a NaN at t=30 and a checkpoint every 20 steps:
    one rollback and one degrade, ``complex2x_packed_ds_cuda ->
    complex2x_plain_ds``."""
    from fdtd3d_torch import faults
    out = os.path.join(DS_K_DIR, "supervised")
    shutil.rmtree(out, ignore_errors=True)
    faults.clear()
    os.environ["FDTD3D_FAULT_PLAN"] = "nan@t=30"
    try:
        log, err, launches, wall, _p = cli_logged(
            ["--cmd-from-file", PRECISION, "--same-size", str(n),
             "--time-steps", str(steps), "--checkpoint-every", "20",
             "--supervise", "--save-dir", out] + COMPLEX,
            "complex float32x2 supervised")
    finally:
        os.environ.pop("FDTD3D_FAULT_PLAN")
        faults.clear()
    rungs = [ln.split("degraded ")[1].split(" -> ") for ln in
             err.splitlines() if "degraded " in ln]
    rec = {"n": n, "steps": steps, "wall_s": wall, "degrades": rungs,
           "launches": {k: launches[k] for k in ("ds_pass", "ds_line")}}
    say(f"complex float32x2 supervised: {json.dumps(rec)}")
    want = ["complex2x_packed_ds_cuda", "complex2x_plain_ds"]
    if "1 rollbacks, 1 ladder degrades (now complex2x_plain_ds" not in log \
            or len(rungs) != 1 or [r.strip() for r in rungs[0]] != want:
        fail(f"complex float32x2 supervised: {rungs}, {log[-300:]}")
    shutil.rmtree(out, ignore_errors=True)
    return rec


def ds_k_and_complex(dev, real_fields=None, ref64=None):
    """Phase 31: magnetic Drude K in the float32x2 kernel (its kernel
    against the plain version, the DNG sphere's accuracy against float64,
    its times with and without K at 256^3), and complex float32x2 as two
    ds legs on that kernel (the CLI main path, times, a supervised
    NaN)."""
    shutil.rmtree(DS_K_DIR, ignore_errors=True)
    rec = {"max_abs_err": ds_k_kernels(dev),
           "accuracy": ds_k_accuracy(dev),
           "times": ds_k_times(dev),
           "complex_main_path": complex_ds_main_path(dev, real_fields,
                                                     ref64),
           "complex_times": complex_ds_times(dev),
           "complex_supervised": complex_ds_supervised()}
    shutil.rmtree(DS_K_DIR, ignore_errors=True)
    return rec


# --------------------------------------------------------------------------
# phase 32: domain decomposition in one process (the sharded packed step)
# --------------------------------------------------------------------------

SHARDED_TOPOLOGIES = ((2, 2, 1), (1, 1, 2))


def clone_tree(tree):
    """A copy of a carry with lists (the sharded carry's shards) too."""
    import torch
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def topo_flag(topo):
    return ["--manual-topology", "x".join(str(p) for p in topo)]


def seeded_sharded_sim(cfg, devices, seed):
    """A decomposed Simulation with every shard's E, H (J, K) seeded from
    one torch generator on the first device."""
    import torch
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(cfg, devices=devices)
    g = torch.Generator(device=devices[0]).manual_seed(seed)
    for ps in sim._carry["shards"]:
        for key in ("E", "H", "J", "K"):
            if key in ps:
                ps[key].copy_((0.01 * torch.randn(
                    ps[key].shape, generator=g, device=devices[0])).to(
                        ps[key].device))
    return sim


def sharded_calls(step, carry, cc, family, fns):
    """One family's launch on every shard of ``carry`` (after its ghost
    exchange) with ``fns`` = (E function, H function)."""
    shards = carry["shards"]
    if family == "E":
        gh = step.exchange(shards, -1)
        for r, ps in enumerate(shards):
            fns[0](ps["E"], ps["H"], ps.get("J"), ps["psE"], cc[r]["E"],
                   ps.get("rE"), ghost=gh[r])
    else:
        gh = step.exchange(shards, 1)
        for r, ps in enumerate(shards):
            fns[1](ps["H"], ps["E"], ps["psH"], cc[r]["H"], ps.get("K"),
                   ps.get("rH"), ghost=gh[r])


def sharded_kernels_vs_plain(cfg, devices, seed, label, tol):
    """The sharded launches against their plain versions, shard by
    shard, on one seeded carry: one E launch, one H launch (each after
    its exchange), then one whole sharded step; -> worst errors."""
    import torch
    from fdtd3d_torch.ops import packed
    sim = seeded_sharded_sim(cfg, devices, seed)
    k_step = packed.make_sharded_packed_step(sim.static, sim.mesh)
    p_step = packed.make_sharded_packed_step(sim.static, sim.mesh,
                                             plain=True)
    cc = k_step.prepare(sim.coeffs)
    kern = (packed.e_update_sharded, packed.h_update_sharded)
    plain = (packed.e_update_plain, packed.h_update_plain)
    errs = {}
    base = sim._carry
    for fam in ("E", "H"):
        a, b = clone_tree(base), clone_tree(base)
        sharded_calls(k_step, a, cc, fam, kern)
        sharded_calls(p_step, b, cc, fam, plain)
        torch.cuda.synchronize()
        errs[fam] = max(compare(ka, kb, f"{label}: one sharded {fam} "
                                f"launch, shard {r}", family=True, tol=tol)
                        for r, (ka, kb) in enumerate(zip(a["shards"],
                                                         b["shards"])))
    a, b = clone_tree(base), clone_tree(base)
    a = k_step(a, cc)
    b = p_step(b, cc)
    torch.cuda.synchronize()
    errs["step"] = max(compare(ka, kb, f"{label}: one sharded step, shard "
                               f"{r}", family=True, tol=tol)
                       for r, (ka, kb) in enumerate(zip(a["shards"],
                                                        b["shards"])))
    say(f"{label}: sharded launches match their plain versions shard by "
        f"shard (max abs err {errs})")
    return errs


def state_vs(got, want, what, tol):
    """Max |diff| of two global states (``host_state``'s: tensors on the
    card, psi expanded on the host), gated at ``tol`` of the family max;
    prints the first differing cell of each leaf that differs; ->
    (worst, bit-equal)."""
    import numpy as np
    import torch

    def flat(t, p=""):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from flat(v, f"{p}{k}/")
            else:
                yield f"{p}{k}", torch.as_tensor(v)
    gw = dict(flat(want))
    fam = {}
    for name, v in gw.items():
        top = name.split("/")[0]
        fam[top] = max(fam.get(top, 0.0), float(v.abs().max()))
    worst, same, bad = 0.0, True, []
    for name, a in flat(got):
        b = gw[name].to(a.device)
        d = (a.double() - b.double()).abs()
        err = float(d.max())
        scale = fam[name.split("/")[0]]
        rel = err / scale if scale > 0 else err
        if err > 0:
            where = np.unravel_index(int(torch.argmax(d)), tuple(d.shape))
            say(f"{what}: {name} max|diff| {err:.3e} (rel {rel:.3e} of "
                f"{scale:.3e}) at {tuple(int(v) for v in where)}, "
                f"{int((d > 0).sum())} cells differ")
        if not rel < tol:
            bad.append(f"{name} rel {rel:.3e}")
        worst = max(worst, err)
        same = same and err == 0.0
        del d
    if bad:
        fail(f"{what}: {'; '.join(bad)} >= {tol}")
    return worst, same


def host_state(sim):
    """A Simulation's global state for ``state_vs``: E, H (and J, K) as
    copies on the card, psi on the host expanded to the full axis from
    its topology's slab layout (``io.psi_slab_expand``)."""
    from fdtd3d_torch import convert, io
    from fdtd3d_torch.solver import slab_axes
    slabs = slab_axes(sim.static)
    tree = {}
    for k, v in sim.state.items():
        if not isinstance(v, dict) or k == "inc":
            continue
        if k.startswith("psi"):
            tree[k] = {}
            for key, arr in v.items():
                a = "xyz".index(key[-1])
                tree[k][key] = io.psi_slab_expand(
                    convert.to_host(arr), a, sim.static.grid_shape[a],
                    sim.topology[a], slabs.get(a))
        else:
            tree[k] = {kk: vv.float() for kk, vv in v.items()}
    return tree


def sharded_run(argv, devices, steps, path=EXAMPLE):
    """A decomposed run through Simulation(devices=...): the sharded
    kernels' counts set to 0 just before it is driven and read after,
    its wall, the peak memory it added (from its construction on), and
    its state."""
    import torch
    from fdtd3d_torch.ops import packed
    from fdtd3d_torch.sim import Simulation
    cfg = config(path, argv)
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()   # the references' states
    sim = Simulation(cfg, devices=devices)
    if sim.step_kind != "packed_cuda" or sim.mesh is None:
        fail(f"{argv}: ran {sim.step_kind} (mesh {sim.mesh}), not the "
             f"sharded packed_cuda step")
    reset_launches()
    packed.e_update_sharded.launches = packed.h_update_sharded.launches = 0
    t0 = time.time()
    sim.run(steps)
    sim.block_until_ready()
    wall = time.time() - t0
    launches = {"e_update_sharded": packed.e_update_sharded.launches,
                "e_update": packed.e_update.launches,
                "h_update_sharded": packed.h_update_sharded.launches,
                "h_update": packed.h_update.launches}
    want = steps * sim.mesh.n
    if launches != {"e_update_sharded": want, "h_update_sharded": want,
                    "e_update": 0, "h_update": 0}:
        fail(f"{argv}: sharded launches {launches}, want {want} of each "
             f"sharded launch and no unsharded one")
    return {"sim": sim, "wall_s": wall, "launches": launches,
            "peak_mem_bytes": torch.cuda.max_memory_allocated() - held,
            "tb_fallback": sim.step_diag["tb_fallback"]["reason"]}


def unsharded_run(argv, dev, steps, temporal, path=EXAMPLE):
    """The unsharded run of the same argv: the tb pass (``temporal``) or
    the packed step (under ``FDTD3D_NO_TEMPORAL``)."""
    from fdtd3d_torch.sim import Simulation
    cfg = config(path, argv)
    saved = os.environ.get("FDTD3D_NO_TEMPORAL")
    if not temporal:
        os.environ["FDTD3D_NO_TEMPORAL"] = "1"
    try:
        sim = Simulation(cfg, device=dev)
        want = "packed_tb_cuda" if temporal else "packed_cuda"
        if sim.step_kind != want:
            fail(f"{argv}: ran {sim.step_kind}, not {want}")
        sim.run(steps)
        sim.block_until_ready()
    finally:
        if saved is None:
            os.environ.pop("FDTD3D_NO_TEMPORAL", None)
        else:
            os.environ["FDTD3D_NO_TEMPORAL"] = saved
    return sim


def sharded_times(dev, reps=20, plain_reps=2):
    """Same-call CUDA-event times at 256^3 (vacuum3D_tfsf): the sharded
    step on (2,2,1) with four shards on the card, its two exchanges, one
    shard's E and H launch (beside their plain versions and bounds: the
    shard's bytes and its ghost planes' reads), and the unsharded packed
    step."""
    import torch
    from fdtd3d_torch.ops import packed
    from fdtd3d_torch.sim import Simulation
    cfg = config(EXAMPLE, ["--same-size", "256"] + topo_flag((2, 2, 1)))
    sim = seeded_sharded_sim(cfg, [dev] * 4, 41)
    step = packed.make_sharded_packed_step(sim.static, sim.mesh)
    cc = step.prepare(sim.coeffs)
    carry = sim._carry
    out = {"step_ms": timed(lambda: step(carry, cc), reps),
           "exchange_ms": timed(lambda: (
               step.exchange(carry["shards"], -1),
               step.exchange(carry["shards"], 1)), reps)}
    ps, c0 = carry["shards"][0], cc[0]
    gh, ge = step.ghosts[-1][0], step.ghosts[1][0]
    out["e_update_ms"] = timed(lambda: packed.e_update_sharded(
        ps["E"], ps["H"], ps.get("J"), ps["psE"], c0["E"], ghost=gh), reps)
    out["h_update_ms"] = timed(lambda: packed.h_update_sharded(
        ps["H"], ps["E"], ps["psH"], c0["H"], ghost=ge), reps)
    out["e_plain_ms"] = timed(lambda: packed.e_update_plain(
        ps["E"], ps["H"], ps.get("J"), ps["psE"], c0["E"], ghost=gh),
        plain_reps)
    out["h_plain_ms"] = timed(lambda: packed.h_update_plain(
        ps["H"], ps["E"], ps["psH"], c0["H"], ghost=ge), plain_reps)
    for fam, g in (("E", gh), ("H", ge)):
        # the ghosts' two components of each plane, read once
        nbytes = family_bytes(ps, c0, fam) + sum(
            2 * v[0].numel() * v.element_size() for v in g.values())
        b = bound(nbytes, family_flops(ps, fam))
        out[f"{fam.lower()}_bound_ms"], out[f"{fam.lower()}_bound_by"] = b
    del sim, step, cc, carry
    os.environ["FDTD3D_NO_TEMPORAL"] = "1"
    try:
        ref = seeded_sim(config(EXAMPLE, ["--same-size", "256"]), dev, 41)
    finally:
        os.environ.pop("FDTD3D_NO_TEMPORAL", None)
    ustep = packed.make_packed_step(ref.static, dev)
    ucc = ustep.prepare(ref.coeffs)
    ucarry = ref._carry
    out["unsharded_step_ms"] = timed(lambda: ustep(ucarry, ucc), reps)
    say("sharded times at 256^3 on (2,2,1), four shards on one card: "
        + json.dumps(out))
    return out


def sharded(dev):
    """Phase 32: the sharded packed step on one card (several shards a
    card), and on distinct cards where there are more."""
    import numpy as np
    import torch
    from fdtd3d_torch import plan as plan_mod
    rec = {"max_abs_err": {}}
    cfg221 = config(EXAMPLE, ["--same-size", "256"] + topo_flag((2, 2, 1)))
    # (a) each sharded launch against its plain version, shard by shard
    rec["max_abs_err"]["f32"] = sharded_kernels_vs_plain(
        cfg221, [dev] * 4, 32, "256^3 (2,2,1)", TOL)
    rec["max_abs_err"]["bf16"] = sharded_kernels_vs_plain(
        config(EXAMPLE, ["--same-size", "256", "--dtype", "bfloat16"]
               + topo_flag((2, 2, 1))), [dev] * 4, 33,
        "256^3 (2,2,1) bf16", BF16_TOL)
    # (b) the main path at full width against the unsharded runs
    steps = 150
    base = ["--same-size", "256", "--time-steps", str(steps)]
    packed_ref = host_state(unsharded_run(base, dev, steps, False))
    tb_ref = host_state(unsharded_run(base, dev, steps, True))
    main = {}
    for topo in SHARDED_TOPOLOGIES:
        run = sharded_run(base + topo_flag(topo), [dev] * int(np.prod(topo)),
                          steps)
        got = host_state(run.pop("sim"))
        err, same = state_vs(got, packed_ref, f"{topo} vs unsharded packed",
                             TOL)
        # the fields: at normal incidence psi holds only the TFSF
        # boundary's roundoff (its max ~1e-9 of E's), where every route,
        # the reference's own included, differs by psi's own size; E and
        # H agree at ~2e-7
        err_tb, _ = state_vs({g: got[g] for g in ("E", "H")},
                             {g: tb_ref[g] for g in ("E", "H")},
                             f"{topo} vs unsharded tb (E, H)", TOL)
        run.update(vs_packed_max_abs=err, bit_equal_packed=same,
                   vs_tb_max_abs=err_tb)
        main["x".join(map(str, topo))] = run
        say(f"main path {topo} on one card, {steps} steps: vs the "
            f"unsharded packed run max abs {err:.3e} (bit-equal {same}), "
            f"vs tb {err_tb:.3e}; launches {run['launches']}; "
            f"{run['wall_s']:.2f} s")
        del got
    del tb_ref
    b16 = base + ["--dtype", "bfloat16"]
    bf_ref = host_state(unsharded_run(b16, dev, steps, False))
    run = sharded_run(b16 + topo_flag((2, 2, 1)), [dev] * 4, steps)
    got = host_state(run.pop("sim"))
    err, same = state_vs(got, bf_ref, "(2,2,1) bf16 vs unsharded bf16",
                         BF16_TOL)
    run.update(vs_packed_max_abs=err, bit_equal_packed=same)
    main["2x2x1_bf16"] = run
    del got, bf_ref
    say(f"main path (2,2,1) bf16: vs the unsharded bf16 packed run max abs "
        f"{err:.3e} (bit-equal {same})")
    rec["main_path"] = main
    # the plan's bytes for (b) beside what the card held
    p221 = plan_mod.plan(cfg221)
    rec["plan_221"] = {"per_shard_bytes": p221.hbm_per_chip,
                       "four_shards_bytes": 4 * p221.hbm_per_chip,
                       "max_memory_allocated": main["2x2x1"]
                       ["peak_mem_bytes"], "report": p221.report()}
    say("plan of (2,2,1) at 256^3 (per shard):\n" + p221.report()
        + f"\n  4 shards: {4 * p221.hbm_per_chip} B; the run's peak "
        f"allocation {main['2x2x1']['peak_mem_bytes']} B")
    # peer copies between cards
    n_cards = torch.cuda.device_count()
    rec["distinct_cards"] = {}
    for topo in ((1, 1, 2), (2, 2, 1)):
        n = int(np.prod(topo))
        if n > n_cards:
            continue
        run = sharded_run(base + topo_flag(topo),
                          [torch.device("cuda", i) for i in range(n)],
                          steps)
        got = host_state(run.pop("sim"))
        err, same = state_vs(got, packed_ref, f"{topo} on {n} cards", TOL)
        run.update(vs_packed_max_abs=err, bit_equal_packed=same)
        rec["distinct_cards"]["x".join(map(str, topo))] = run
        say(f"{topo} on {n} distinct cards (peer copies): max abs "
            f"{err:.3e} (bit-equal {same})")
    if not rec["distinct_cards"]:
        say(f"{n_cards} card: the peer-copy path between cards was not "
            f"run")
    del packed_ref
    # (c) the Mie example's sphere box across every shard edge
    margs = mie_scaled(256)[2:] + ["--time-steps", "100"]
    mie_ref = host_state(unsharded_run(margs + ["--topology", "none"], dev,
                                       100, False, MIE))
    run = sharded_run(margs + topo_flag((2, 2, 1)), [dev] * 4, 100, MIE)
    sim = run.pop("sim")
    err, same = state_vs(host_state(sim), mie_ref, "Mie (2,2,1)", TOL)
    run.update(vs_packed_max_abs=err, bit_equal_packed=same)
    rec["mie_221"] = run
    say(f"Mie 256^3 (2,2,1), 100 steps: vs the unsharded packed run max "
        f"abs {err:.3e} (bit-equal {same})")
    del sim, mie_ref
    # (d) times, and config #5's plan on four devices (printed, not run)
    rec["times"] = sharded_times(dev)
    nano = os.path.join(ROOT, "Examples", "drude3D_nanoantenna.txt")
    p5 = plan_mod.plan(config(nano, ["--num-devices", "4"]), n_devices=4)
    rec["plan_config5_4"] = {"topology": list(p5.topology),
                             "per_device_bytes": p5.hbm_per_chip,
                             "report": p5.report()}
    say("plan of config #5 (drude3D_nanoantenna, 1024^3) on 4 devices:\n"
        + p5.report())
    if not p5.hbm_per_chip < 80e9:
        fail(f"config #5 on 4 devices plans {p5.hbm_per_chip} B a device")
    return rec


# --------------------------------------------------------------------------
# phase 33: float32x2 on a decomposed grid (the sharded packed-ds step)
# --------------------------------------------------------------------------

def exact_trees(got, want, what):
    """Max |diff| over the leaves of two carries (or spare sets), gated
    at 0.0 (by value: -0 equals +0); on a miss prints the first
    differing cells of each leaf that differs and fails."""
    import numpy as np
    import torch
    want_leaves = dict(leaves(want))
    worst, bad = 0.0, []
    for name, a in leaves(got):
        b = want_leaves[name]
        d = (a.double() - b.double()).abs()
        nan = torch.isnan(d)
        err = float(d.nan_to_num(0.0).max())
        if err > 0 or bool(nan.any()):
            first = torch.nonzero((d > 0) | nan)[:5].tolist()
            where = np.unravel_index(int(torch.argmax(d.nan_to_num(0.0))),
                                     tuple(d.shape))
            say(f"{what}: {name} max|diff| {err:.3e} at "
                f"{tuple(int(v) for v in where)}; first cells {first}")
            bad.append(name)
        worst = max(worst, err)
    if bad:
        fail(f"{what}: {', '.join(bad)} differ from the plain version")
    return worst


def ds_sharded_sim(cfg, devices):
    """A decomposed float32x2 Simulation on ``devices`` (the sharded
    packed-ds step)."""
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(cfg, devices=devices)
    if sim.step_kind != "packed_ds_cuda" or sim.mesh is None:
        fail(f"float32x2 on {cfg.parallel.manual_topology}: ran "
             f"{sim.step_kind} (mesh {sim.mesh}), not the sharded "
             f"packed_ds_cuda step")
    return sim


def ds_sharded_launches_vs_plain(sim, seed, label):
    """Phase 33 (a): on a copy of ``sim``'s carry with every shard's E/H
    pairs, J and K seeded, each sharded launch of one step against its
    plain version, shard by shard: the line once per device, the pass
    (after the lo ghost exchange), the hi-edge launch (after the hi
    ghost exchange, on each shard with an upper neighbour; kernel and
    plain from the kernel pass's output), then one whole sharded step
    against the plain sharded step; every gate 0.0. -> worst errors."""
    import torch
    from fdtd3d_torch.ops import packed, packed_ds, tfsf
    static, mesh = sim.static, sim.mesh
    k_step = packed_ds.make_sharded_packed_ds_step(static, mesh)
    p_step = packed_ds.make_sharded_packed_ds_step(static, mesh, plain=True)
    cc = k_step.prepare(sim.coeffs)
    base = clone_tree(sim._carry)
    groups = {}
    for r, sh in enumerate(base["shards"]):
        seed_ds_carry(sh, sh["E"].device, seed + r)
        groups.setdefault(sh["E"].device, r)
    shards = base["shards"]
    t = int(base["t"])
    errs = {"line": 0.0, "pass": 0.0, "hi_edge": 0.0}
    lines = {}
    if static.tfsf_setup is not None:
        pair = tfsf.line_source(static.tfsf_setup, static.omega,
                                static.dt)(t)
        for d, r in groups.items():
            inc = shards[r]["inc"]
            lk = {k: torch.empty_like(v) for k, v in inc.items()}
            lp = {k: torch.empty_like(v) for k, v in inc.items()}
            packed_ds.line_advance(inc, lk, cc[r], pair)
            packed_ds.line_advance_plain(inc, lp, cc[r], pair)
            torch.cuda.synchronize()
            errs["line"] = max(errs["line"], exact_trees(
                lk, lp, f"{label}: the line, device {d}"))
            lines[d] = lk
    ps = static.cfg.point_source
    point = None
    if ps.enabled:
        from fdtd3d_torch.ops.sources import DsSourceTable
        point = DsSourceTable(ps.waveform, 0.5, static.omega, static.dt,
                              ps.amplitude)(t)
    lo = k_step.exchange(shards, -1)
    outs = []
    for r, sh in enumerate(shards):
        d = sh["E"].device
        args = (cc[r], sh.get("inc"), lines.get(d),
                point if cc[r]["has_point"] else None)
        a, b = packed.alloc_like(sh), packed.alloc_like(sh)
        packed_ds.ds_pass_sharded(sh, a, *args, lo[r])
        packed_ds.ds_pass_plain(sh, b, *args, lo[r])
        torch.cuda.synchronize()
        errs["pass"] = max(errs["pass"], exact_trees(
            a, b, f"{label}: the sharded pass, shard {r}"))
        outs.append((a, args))
    hi = k_step.exchange([a for a, _ in outs], 1)
    n_edge = 0
    for r, (sh, (a, args)) in enumerate(zip(shards, outs)):
        if not hi[r]:
            continue
        b = clone_tree(a)
        packed_ds.hi_edge_h(sh, a, *args[:3], hi[r])
        packed_ds.hi_edge_h_plain(sh, b, *args[:3], hi[r])
        torch.cuda.synchronize()
        errs["hi_edge"] = max(errs["hi_edge"], exact_trees(
            a, b, f"{label}: the hi-edge launch, shard {r}"))
        n_edge += 1
    del outs
    a, b = clone_tree(base), base
    a = k_step(a, cc)
    b = p_step(b, cc)
    torch.cuda.synchronize()
    errs["step"] = max(exact_trees(ka, kb, f"{label}: one sharded ds step, "
                                   f"shard {r}")
                       for r, (ka, kb) in enumerate(zip(a["shards"],
                                                        b["shards"])))
    say(f"{label}: the sharded ds launches (pass on {mesh.n} shards, "
        f"hi-edge H on {n_edge}) and one step equal their plain versions "
        f"(max abs err {errs})")
    return errs


def ds_sharded_run(sim, steps):
    """Phase 33 (b): ``steps`` steps of a decomposed float32x2
    Simulation, its kernels' counts set to 0 just before and read just
    after: the sharded pass on every shard a step, the hi-edge launch on
    every shard with an upper neighbour, the line once a device, and no
    unsharded pass."""
    import numpy as np
    from fdtd3d_torch.ops import packed_ds
    reset_launches()
    t0 = time.time()
    sim.run(steps)
    sim.block_until_ready()
    wall = time.time() - t0
    mesh = sim.mesh
    edges = sum(any(up for _, up in mesh.open_sides(r))
                for r in range(mesh.n))
    got = {"ds_pass_sharded": packed_ds.ds_pass_sharded.launches,
           "hi_edge_h": packed_ds.hi_edge_h.launches,
           "ds_line": packed_ds.line_advance.launches,
           "ds_pass": packed_ds.ds_pass.launches}
    want = {"ds_pass_sharded": steps * mesh.n, "hi_edge_h": steps * edges,
            "ds_line": steps * len(mesh.distinct_devices())
            if sim.static.tfsf_setup is not None else 0, "ds_pass": 0}
    if got != want:
        fail(f"sharded float32x2 {tuple(mesh.topology)}: launches {got}, "
             f"want {want}")
    return {"wall_s": wall, "launches": got,
            "kernels_per_shard_step": packed_ds.ds_pass_sharded.kernels
            / (steps * mesh.n),
            "topology": list(int(p) for p in np.asarray(mesh.topology))}


def ds_state(sim):
    """``host_state`` of a float32x2 run with its lo words and its line:
    E, loE, H, loH, J, K and inc on the card, the psi pairs (``psi_*``
    and ``lopsi_*``) on the host expanded to the full axis."""
    from fdtd3d_torch import convert, io
    from fdtd3d_torch.solver import slab_axes
    slabs = slab_axes(sim.static)
    tree = {}
    for k, v in sim.state.items():
        if not isinstance(v, dict):
            continue
        if "psi" in k:
            tree[k] = {}
            for key, arr in v.items():
                a = "xyz".index(key[-1])
                tree[k][key] = io.psi_slab_expand(
                    convert.to_host(arr), a, sim.static.grid_shape[a],
                    sim.topology[a], slabs.get(a))
        else:
            tree[k] = {kk: vv.float() for kk, vv in v.items()}
    return tree


def hi_edge_bytes_flops(carry, cc, ghost):
    """(bytes, f32 operations) of one hi-edge launch: per hi-edge cell
    the old H pair read, the new H pair written and the new E pair of
    the cell read (its +1 neighbours are other cells' or the ghosts'),
    psi pairs of the cell's slab planes read and written, K read and
    written; each ghost plane's two components' pairs read once; the H
    half of ``ds_pass_flops`` a cell (two differences, the sign, the
    pair sum, the coefficient products: 174 a component; 118 a psi
    pair, 16 K a component)."""
    import numpy as np
    shape = cc["shape"]
    mask = np.zeros(shape, bool)
    for b, i in [(b, shape[b] - 1) for b in range(3) if cc["open"][b][1]]:
        idx = [slice(None)] * 3
        idx[b] = i
        mask[tuple(idx)] = True
    cells = int(mask.sum())
    slab = 0
    for a, m in cc["H"]["m"].items():
        n = shape[a]
        sl = [slice(None)] * 3
        keep = np.zeros(n, bool)
        keep[:m] = keep[n - m:] = True
        sl[a] = keep
        slab += int(mask[tuple(sl)].sum()) * 2   # two rows a psi stack
    nbytes = cells * 3 * 24 + slab * 2 * 8
    ops = cells * 3 * 174 + slab * 118
    if "K" in carry:
        nbytes += cells * 3 * 8
        ops += cells * 3 * 16
    nbytes += sum(4 * 4 * v[0].numel() for v in ghost.values())
    return nbytes, ops


def ds_bound(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_NONFMA_OPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def device_ms(fn, names):
    """``fn()`` under torch.profiler: per kernel name of ``names`` (a
    function template's instances included: the trace names them
    ``void name<...>(...)``), (launches, mean device ms a launch) from
    the Chrome trace, and the device ms of every kernel; (0, None)
    where the trace holds none of that name (the profiler drops events
    in a long process, phase 29)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "ds_sharded_trace.json")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("cat") == "kernel"]
    os.remove(path)
    out = {"all_ms": sum(ev.get("dur", 0.0) for ev in events) / 1e3}
    for name in names:
        durs = [ev.get("dur", 0.0) for ev in events
                if ev.get("name", "").replace("void ", "", 1)
                .startswith(name)]
        out[name] = (len(durs), sum(durs) / len(durs) / 1e3 if durs
                     else None)
    return out


def ds_sharded_times(sim, one, label, reps=20, plain_reps=2, traced=5):
    """Phase 33 (c): same-call CUDA-event times on seeded copies of a
    decomposed float32x2 run's state (``sim``: four shards on the card)
    and of the unsharded run's (``one``): the sharded ds step, its two
    exchanges, shard 0's pass and hi-edge launch beside their plain
    versions and bounds, and the unsharded ds step; then, under
    torch.profiler, ``reps`` sharded steps' device time and their
    kernels' (the pass's section kernels, the hi-edge launch) over
    ``traced`` steps."""
    import torch
    from fdtd3d_torch.ops import packed, packed_ds
    for r, sh in enumerate(sim._carry["shards"]):
        seed_ds_carry(sh, sh["E"].device, 330 + r)
    seed_ds_carry(one._carry, one.device, 339)
    step = packed_ds.make_sharded_packed_ds_step(sim.static, sim.mesh)
    cc = step.prepare(sim.coeffs)
    carry = sim._carry
    ustep = packed_ds.make_packed_ds_step(one.static, one.device)
    ucc = ustep.prepare(one.coeffs)
    ucarry = one._carry
    out = {"step_ms": timed(lambda: step(carry, cc), reps),
           "unsharded_step_ms": timed(lambda: ustep(ucarry, ucc), reps)}
    out["step_over_unsharded"] = out["step_ms"] / out["unsharded_step_ms"]
    spare = [packed.alloc_like(sh) for sh in carry["shards"]]
    out["exchange_ms"] = timed(lambda: (step.exchange(carry["shards"], -1),
                                        step.exchange(spare, 1)), reps)
    sh, c0 = carry["shards"][0], cc[0]
    inc = sh.get("inc")
    line = {k: v.clone() for k, v in inc.items()} if inc else None
    point = (0.0, 0.0) if c0["has_point"] else None
    lo = step.exchange(carry["shards"], -1)[0]
    dst = spare[0]
    packed_ds.ds_pass_sharded(sh, dst, c0, inc, line, point, lo)
    hi = step.exchange(spare, 1)[0]
    args = (sh, dst, c0, inc, line)
    out.update(
        pass_ms=timed(lambda: packed_ds.ds_pass_sharded(*args, point, lo),
                      reps),
        pass_plain_ms=timed(lambda: packed_ds.ds_pass_plain(*args, point,
                                                            lo), plain_reps),
        hi_edge_ms=timed(lambda: packed_ds.hi_edge_h(*args, hi), reps),
        hi_edge_plain_ms=timed(lambda: packed_ds.hi_edge_h_plain(*args, hi),
                               plain_reps))
    # the pass: a shard's bytes and operations, its lo ghosts' two
    # components' pairs read once
    nbytes = ds_pass_bytes(sh, c0) + sum(4 * 4 * v[0].numel()
                                         for v in lo.values())
    out["pass_bound_ms"], out["pass_bound_by"] = ds_bound(
        nbytes, ds_pass_flops(sh, c0))
    out["hi_edge_bound_ms"], out["hi_edge_bound_by"] = ds_bound(
        *hi_edge_bytes_flops(sh, c0, hi))
    out["pass_items"] = [int(n) for n in c0["_plan"][1][1]] \
        if "_plan" in c0 else None
    out["shard_shape"] = list(c0["shape"])
    # device time: the kernels of ``traced`` sharded steps
    t0 = time.time()
    dev_ms = device_ms(lambda: [step(carry, cc) for _ in range(traced)],
                       ("ds_section", "ds_hi_edge", "ds_line"))
    wall = (time.time() - t0) * 1e3 / traced
    out["device"] = {
        "step_kernels_ms": dev_ms["all_ms"] / traced,
        "pass_section_launches": dev_ms["ds_section"][0],
        "pass_section_ms": dev_ms["ds_section"][1],
        "hi_edge_launches": dev_ms["ds_hi_edge"][0],
        "hi_edge_ms": dev_ms["ds_hi_edge"][1],
        "line_ms": dev_ms["ds_line"][1],
        "profiled_step_wall_ms": wall}
    say(f"{label} ds times, (2,2,1) four shards on one card: "
        + json.dumps(out))
    del step, cc, carry, spare, dst, sh, args, ustep, ucc, ucarry
    torch.cuda.empty_cache()
    return out


def ds_sharded(dev):
    """Phase 33: float32x2 on a decomposed grid, four (or two) shards on
    ``cuda:0`` through ``Simulation(cfg, devices=[...])``: (b) each run
    against the unsharded ds run (the peak allocation of each measured
    from its construction through its run), then (a) on a seeded copy
    of its final state, and (c) on seeded copies of both runs'
    states."""
    import numpy as np
    import torch
    from fdtd3d_torch import plan as plan_mod
    from fdtd3d_torch.sim import Simulation
    rec = {"max_abs_err": {}, "main_path": {}, "times": {}}
    main = rec["main_path"]
    for label, path, argv, topos, key in (
            ("precision 128^3", PRECISION, [], ((2, 2, 1), (1, 1, 2)),
             "precision"),
            ("DNG 256^3", MIE, dng_flags(256, 40) + X2, ((2, 2, 1),),
             "dng")):
        one = Simulation(config(path, argv), device=dev)
        if one.step_kind != "packed_ds_cuda":
            fail(f"{label} ran {one.step_kind}, not packed_ds_cuda")
        one.run()
        one.block_until_ready()
        want = ds_state(one)
        for topo in topos:
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            sim = ds_sharded_sim(config(path, argv + topo_flag(topo)),
                                 [dev] * int(np.prod(topo)))
            run = ds_sharded_run(sim, one.cfg.time_steps)
            run["peak_mem_bytes"] = torch.cuda.max_memory_allocated() - held
            run["tb_fallback"] = sim.step_diag["tb_fallback"]["reason"]
            err, same = state_vs(ds_state(sim), want,
                                 f"{label} {topo} vs unsharded ds", 1e-9)
            if not same:
                fail(f"{label} {topo}: not bit-equal to the unsharded ds "
                     f"run (max abs {err:.3e})")
            run.update(vs_unsharded_max_abs=err, bit_equal=same)
            main[f"{key}_{'x'.join(map(str, topo))}"] = run
            say(f"{label} {topo}, {one.cfg.time_steps} steps: bit-equal to "
                f"the unsharded ds run; launches {run['launches']}; "
                f"{run['wall_s']:.2f} s; peak {run['peak_mem_bytes']} B")
            if topo == (2, 2, 1):
                rec["max_abs_err"][key] = ds_sharded_launches_vs_plain(
                    sim, 3300, f"{label} (2,2,1)")
                rec["times"][key] = ds_sharded_times(sim, one, label)
            del sim
        del one, want
        torch.cuda.empty_cache()
    # (d) the (2,2,1) run's peak beside the plan's bytes for four shards
    p = plan_mod.plan(config(PRECISION, topo_flag((2, 2, 1))))
    rec["plan_221"] = {"per_shard_bytes": p.hbm_per_chip,
                       "four_shards_bytes": 4 * p.hbm_per_chip,
                       "max_memory_allocated":
                       main["precision_2x2x1"]["peak_mem_bytes"],
                       "report": p.report()}
    say("plan of the precision example on (2,2,1) (per shard):\n"
        + p.report() + f"\n  4 shards: {4 * p.hbm_per_chip} B; the run's "
        f"peak allocation {main['precision_2x2x1']['peak_mem_bytes']} B")
    return rec

# --------------------------------------------------------------------------
# phase 34: the sharded two-pass family kernels (the sharded two-pass step)
# --------------------------------------------------------------------------

FAMILY_SHARDED = ("e_family_sharded", "h_family_sharded")


def family_shard_calls(local, step, carry, fps, family, fns):
    """One family's launch on every shard of a dict-form sharded carry
    (after its ghost exchange) with ``fns`` = (E function, H function),
    each shard's outputs put into its dict; the record terms and the
    drive of the shard's step (``local``: the shard's static setup)."""
    from fdtd3d_torch.ops import pallas3d, tfsf
    shards = carry["shards"]
    gh = step.exchange(shards, -1 if family == "E" else 1)
    for r, (ps, fp) in enumerate(zip(shards, fps)):
        terms = None
        if local.tfsf_setup is not None:
            inc = tfsf.advance_einc(ps["inc"], fp["coeffs"], ps["t"],
                                    local.dt, local.omega, local.tfsf_setup)
            terms = tfsf.record_terms(fp["plan"], inc)
        key = "psi_" + family
        psi = {k: ps[key][k] for v in fp[family]["psi"].values()
               for _, k in v}
        if family == "E":
            f, p, j = fns[0](ps["E"], ps["H"], psi, ps.get("J"), fp, terms,
                             pallas3d.point_drive(local, fp, ps["t"]),
                             ghost=gh[r])
            ade = "J"
        else:
            f, p, j = fns[1](ps["H"], ps["E"], psi, fp, ps.get("K"), terms,
                             ghost=gh[r])
            ade = "K"
        ps[family] = f
        ps[key] = dict(ps[key], **p)
        if j is not None:
            ps[ade] = j


def seed_family_fields(states, dev, seed):
    """E, H (J, K) of dict-form states (a shard's or an unsharded run's)
    to seeded random values (0.01 sigma) from one generator on
    ``dev``."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    for st in states:
        for key in ("E", "H", "J", "K"):
            for v in st.get(key, {}).values():
                v.copy_((0.01 * torch.randn(v.shape, generator=g,
                                            device=dev)).to(v))


def family_sharded_sim(cfg, devices, seed=None):
    """A decomposed Simulation on ``devices`` under ``FDTD3D_NO_PACKED``
    that must run the sharded two-pass step (``pallas3d_cuda``), every
    shard's E, H (J, K) seeded when ``seed`` is given."""
    from fdtd3d_torch.sim import Simulation
    with ladder_env("FDTD3D_NO_PACKED"):
        sim = Simulation(cfg, devices=devices)
    if sim.step_kind != "pallas3d_cuda" or sim.mesh is None:
        fail(f"{cfg.parallel.manual_topology}: ran {sim.step_kind} (mesh "
             f"{sim.mesh}), not the sharded pallas3d_cuda step")
    if seed is not None:
        seed_family_fields(sim._carry["shards"], devices[0], seed)
    return sim


def family_sharded_vs_plain(cfg, devices, seed, label):
    """Phase 34 (a): on one seeded decomposed carry, the E launch of
    every shard (after its exchange), the H launch of every shard (after
    its exchange), then one whole sharded step, each against the plain
    versions shard by shard; every gate 0.0 (``exact_trees``)."""
    import torch
    from fdtd3d_torch.ops import pallas3d
    from fdtd3d_torch.solver import shard_static
    sim = family_sharded_sim(cfg, devices, seed)
    local = shard_static(sim.static, sim.mesh)
    k_step = pallas3d.make_sharded_pallas_step(sim.static, sim.mesh)
    p_step = pallas3d.make_sharded_pallas_step(sim.static, sim.mesh,
                                               plain=True)
    fps = k_step.prepare(sim.coeffs)
    kern = (pallas3d.e_family_sharded, pallas3d.h_family_sharded)
    plain = (pallas3d.e_family_plain, pallas3d.h_family_plain)
    base = sim._carry
    errs = {}
    for fam in ("E", "H"):
        a, b = clone_tree(base), clone_tree(base)
        family_shard_calls(local, k_step, a, fps, fam, kern)
        family_shard_calls(local, p_step, b, fps, fam, plain)
        torch.cuda.synchronize()
        errs[fam] = max(exact_trees(ka, kb, f"{label}: one sharded {fam} "
                                    f"launch, shard {r}")
                        for r, (ka, kb) in enumerate(zip(a["shards"],
                                                         b["shards"])))
    a, b = clone_tree(base), clone_tree(base)
    a = k_step(a, fps)
    b = p_step(b, fps)
    torch.cuda.synchronize()
    errs["step"] = max(exact_trees(ka, kb, f"{label}: one sharded step, "
                                   f"shard {r}")
                       for r, (ka, kb) in enumerate(zip(a["shards"],
                                                        b["shards"])))
    plan = fps[0].get("_plan_E")
    say(f"{label}: sharded two-pass launches match their plain versions "
        f"shard by shard (max abs err {errs}; shard 0's E items by "
        f"section {plan[1][1] if plan else None})")
    del sim, k_step, p_step, fps, base, a, b
    return errs


def family_sharded_run(cfg, devices, steps):
    """A decomposed two-pass run through Simulation(devices=...): the
    counts set to 0 just before it is driven and read after, its wall,
    the peak memory it added (from its construction on), its state."""
    import torch
    from fdtd3d_torch.ops import pallas3d
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    sim = family_sharded_sim(cfg, devices)
    reset_launches()
    pallas3d.e_family_sharded.launches = 0
    pallas3d.h_family_sharded.launches = 0
    pallas3d.e_family_sharded.kernels = 0
    pallas3d.h_family_sharded.kernels = 0
    t0 = time.time()
    sim.run(steps)
    sim.block_until_ready()
    wall = time.time() - t0
    launches = {k: getattr(pallas3d, k).launches for k in
                FAMILY_SHARDED + ("e_family", "h_family")}
    launches["section_kernels"] = pallas3d.e_family_sharded.kernels \
        + pallas3d.h_family_sharded.kernels
    want = steps * sim.mesh.n
    if (launches["e_family_sharded"], launches["h_family_sharded"],
            launches["e_family"], launches["h_family"]) != (want, want, 0, 0):
        fail(f"{cfg.parallel.manual_topology}: launches {launches}, want "
             f"{want} of each sharded family launch and no unsharded one")
    return {"sim": sim, "wall_s": wall, "launches": launches,
            "kernels_per_step": launches["section_kernels"] / steps,
            "peak_mem_bytes": torch.cuda.max_memory_allocated() - held,
            "tb_fallback": sim.step_diag["tb_fallback"]["reason"]}


def family_unsharded_run(cfg, dev, steps):
    """The unsharded two-pass run of the same configuration
    (``FDTD3D_NO_PACKED`` + ``FDTD3D_NO_FUSED``)."""
    from fdtd3d_torch.sim import Simulation
    with ladder_env("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"):
        sim = Simulation(cfg, device=dev)
    if sim.step_kind != "pallas3d_cuda":
        fail(f"unsharded two-pass run: ran {sim.step_kind}")
    sim.run(steps)
    sim.block_until_ready()
    return sim


def family_sharded_times(dev, reps=20, plain_reps=2):
    """Phase 34 (d): same-call CUDA-event times at 256^3 (vacuum3D_tfsf,
    seeded): the sharded two-pass step on (2,2,1) with four shards on
    the card, its two exchanges, shard 0's E and H launch beside their
    plain versions and bounds (the shard's bytes with its grids in their
    box and its ghost planes' two components read once), and the
    unsharded two-pass step; the launches a step, under the profiler."""
    import torch
    from fdtd3d_torch.ops import pallas3d, tfsf
    from fdtd3d_torch.solver import shard_static
    cfg = config(EXAMPLE, ["--same-size", "256"] + topo_flag((2, 2, 1)))
    sim = family_sharded_sim(cfg, [dev] * 4, 341)
    step = pallas3d.make_sharded_pallas_step(sim.static, sim.mesh)
    fps = step.prepare(sim.coeffs)
    carry = sim._carry
    local = shard_static(sim.static, sim.mesh)
    out = {"step_ms": timed(lambda: step(carry, fps), reps),
           "exchange_ms": timed(lambda: (
               step.exchange(carry["shards"], -1),
               step.exchange(carry["shards"], 1)), reps)}
    ps, fp = carry["shards"][0], fps[0]
    gh, ge = step.ghosts[-1][0], step.ghosts[1][0]
    inc = tfsf.advance_einc(ps["inc"], fp["coeffs"], ps["t"], local.dt,
                            local.omega, local.tfsf_setup)
    terms = tfsf.record_terms(fp["plan"], inc)
    drive = pallas3d.point_drive(local, fp, ps["t"])
    pe = {k: ps["psi_E"][k] for v in fp["E"]["psi"].values() for _, k in v}
    ph = {k: ps["psi_H"][k] for v in fp["H"]["psi"].values() for _, k in v}
    e_args = (ps["E"], ps["H"], pe, ps.get("J"), fp, terms, drive)
    h_args = (ps["H"], ps["E"], ph, fp, ps.get("K"), terms)
    lib = pallas3d._library()
    for name, args, g in (("e_family", e_args, gh), ("h_family", h_args,
                                                      ge)):
        fam = name[0].upper()
        F, S, psi = args[0], args[1], args[2]
        J = args[3] if fam == "E" else args[4]
        first = F[fp[fam]["comps"][0]]
        prm = pallas3d._params(
            F, S, psi, J, fp, fam, terms, drive if fam == "E" else None,
            *pallas3d.launch_geometry(lib, first, fp["shape"][2]),
            ghost=g)[0]
        fn = "fdtd_e_family" if fam == "E" else "fdtd_h_family"
        out[f"{name}_launch_ms"] = timed(
            lambda: pallas3d.launch(lib, fn, prm, first.device), reps)
        wrapper = getattr(pallas3d, f"{name}_sharded")
        out[f"{name}_ms"] = timed(lambda: wrapper(*args, ghost=g), reps)
        plain = getattr(pallas3d, f"{name}_plain")
        out[f"{name}_plain_ms"] = timed(lambda: plain(*args, ghost=g),
                                        plain_reps)
        nbytes = ladder_bytes(local, fp["coeffs"], ps, name, fp) + sum(
            2 * v[0].numel() * v.element_size() for v in g.values())
        out[f"{name}_bound_ms"], out[f"{name}_bound_by"] = bound(
            nbytes, ladder_ops(local, ps, name))
        out[f"{name}_bytes"] = nbytes
    dev_ms = device_ms(lambda: [step(carry, fps) for _ in range(5)],
                       ("family_section",))
    out["device"] = {"step_kernels_ms": dev_ms["all_ms"] / 5,
                     "section_launches_a_step":
                     dev_ms["family_section"][0] / 5,
                     "section_ms": dev_ms["family_section"][1]}
    out["shard_shape"] = list(fp["shape"])
    del sim, step, fps, carry, ps, fp, e_args, h_args, prm
    torch.cuda.empty_cache()
    from fdtd3d_torch.sim import Simulation
    with ladder_env("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED"):
        ref = Simulation(config(EXAMPLE, ["--same-size", "256"]), device=dev)
        ustep = pallas3d.make_pallas_step(ref.static, dev)
    seed_family_fields([ref._carry], dev, 341)
    ufp = ustep.prepare(ref.coeffs)
    ust = ref._carry
    out["unsharded_step_ms"] = timed(lambda: ustep(ust, ufp), reps)
    out["step_over_unsharded"] = out["step_ms"] / out["unsharded_step_ms"]
    say("sharded two-pass times at 256^3 on (2,2,1), four shards on one "
        "card: " + json.dumps(out))
    del ref, ustep, ufp, ust
    torch.cuda.empty_cache()
    return out


def family_sharded(dev):
    """Phase 34: the sharded two-pass step (B3(c)) on one card, four or
    two shards on ``cuda:0`` through ``Simulation(cfg, devices=[...])``:
    (a) each sharded launch and one step against the plain versions,
    (b) the main paths bit-equal to the unsharded two-pass runs, (c) the
    thin-y example, (d) times and the plan."""
    import numpy as np
    import torch
    from fdtd3d_torch import plan as plan_mod
    rec = {"max_abs_err": {}, "main_path": {}}
    # (a) each sharded launch against its plain version, shard by shard
    for key, extra in (("f32", []), ("bf16", ["--dtype", "bfloat16"])):
        rec["max_abs_err"][key] = family_sharded_vs_plain(
            config(EXAMPLE, ["--same-size", "256"] + extra
                   + topo_flag((2, 2, 1))), [dev] * 4, 340,
            f"256^3 (2,2,1) {key}")
    # (b) the main path at full width against the unsharded runs
    main = rec["main_path"]
    for label, path, argv, steps, topos in (
            ("vacuum 256^3", EXAMPLE, ["--same-size", "256"], 150,
             ((2, 2, 1), (1, 1, 2))),
            ("vacuum 256^3 bf16", EXAMPLE,
             ["--same-size", "256", "--dtype", "bfloat16"], 150,
             ((2, 2, 1), (1, 1, 2))),
            ("Mie 512^3", MIE, [], 100, ((2, 2, 1),))):
        one = family_unsharded_run(
            config(path, argv + ["--topology", "none"]), dev, steps)
        want = host_state(one)
        del one
        for topo in topos:
            run = family_sharded_run(config(path, argv + topo_flag(topo)),
                                     [dev] * int(np.prod(topo)), steps)
            got = host_state(run.pop("sim"))
            err, same = state_vs(got, want, f"{label} {topo} vs the "
                                 f"unsharded two-pass run", TOL)
            if not same:
                fail(f"{label} {topo}: not bit-equal to the unsharded "
                     f"two-pass run (max abs {err:.3e})")
            run.update(vs_unsharded_max_abs=err, bit_equal=same)
            main[f"{label} {'x'.join(map(str, topo))}"] = run
            say(f"{label} {topo}, {steps} steps: bit-equal to the "
                f"unsharded two-pass run; launches {run['launches']}; "
                f"{run['wall_s']:.2f} s; peak {run['peak_mem_bytes']} B; "
                f"token {run['tb_fallback']}")
            del got
        del want
        torch.cuda.empty_cache()
    # (c) the example as it stands (64^3, pml 8) on (1,4,1): a local y of
    # 16 holds no slab psi, so y psi is full-length; the CLI's own
    # configuration (one card takes no four-shard CLI run, the CLI's
    # _check_topology_fits), run through Simulation
    from fdtd3d_torch import cli
    argv = cli.read_cmd_file(EXAMPLE)
    steps = cli.args_to_config(cli.build_parser().parse_args(
        argv)).time_steps
    cfg141 = cli.args_to_config(cli.build_parser().parse_args(
        argv + topo_flag((1, 4, 1))))
    one = host_state(family_unsharded_run(config(EXAMPLE, []), dev, steps))
    from fdtd3d_torch.sim import Simulation
    sim = Simulation(cfg141, devices=[dev] * 4)
    if sim.step_kind != "pallas3d_cuda" or \
            sim.step_diag["tb_fallback"]["reason"] != "thin_grid_psi":
        fail(f"the example on (1,4,1) ran {sim.step_kind} "
             f"({sim.step_diag}), not pallas3d_cuda with thin_grid_psi")
    sim.run()
    sim.block_until_ready()
    err, same = state_vs(host_state(sim), one, "64^3 (1,4,1) thin y vs the "
                         "unsharded two-pass run", TOL)
    rec["thin_141"] = {"steps": steps, "vs_unsharded_max_abs": err,
                       "bit_equal": same,
                       "tb_fallback": sim.step_diag["tb_fallback"]["reason"]}
    say(f"the example as it stands on (1,4,1) (full-length y psi), {steps} "
        f"steps: vs the unsharded two-pass run max abs {err:.3e} "
        f"(bit-equal {same})")
    del sim, one
    # (d) times, and the (2,2,1) run's peak beside the plan's bytes
    rec["times"] = family_sharded_times(dev)
    with ladder_env("FDTD3D_NO_PACKED"):
        p = plan_mod.plan(config(EXAMPLE, ["--same-size", "256"]
                                 + topo_flag((2, 2, 1))))
    peak = main["vacuum 256^3 2x2x1"]["peak_mem_bytes"]
    rec["plan_221"] = {"per_shard_bytes": p.hbm_per_chip,
                       "four_shards_bytes": 4 * p.hbm_per_chip,
                       "spare_bytes": p.spare_bytes,
                       "max_memory_allocated": peak, "report": p.report()}
    say("plan of vacuum3D_tfsf 256^3 on (2,2,1) under FDTD3D_NO_PACKED "
        "(per shard):\n" + p.report() + f"\n  4 shards: "
        f"{4 * p.hbm_per_chip} B; the run's peak allocation {peak} B")
    return rec


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the measurements as JSON here")
    ap.add_argument("--only", default=None, metavar="27,...,34",
                    help="run only these of phases 27 to 34 (after the "
                         "build) and print their JSON, without the "
                         "kernels line and the closing ok line")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this proof needs a GPU")
    try:
        from fdtd3d_torch import cli
        from fdtd3d_torch.io import load_dat
        from fdtd3d_torch.ops import build, packed, packed_ds, packed_tb
        from fdtd3d_torch.sim import Simulation
        from fdtd3d_torch.solver import build_static
    except ImportError as exc:
        fail(f"the port is not importable from {ROOT}: {exc}")
    if "jax" in sys.modules or any(m.startswith("fdtd3d_tpu")
                                   for m in sys.modules):
        fail("the port pulled in jax or the reference package")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    result = {"device": name}

    # ---- build -----------------------------------------------------------
    start = t0 = time.time()

    def mark(name):
        """Seconds since the build started, at the end of ``name``."""
        result.setdefault("elapsed_s", {})[name] = round(
            time.time() - start, 1)
        say(f"{name} done, {result['elapsed_s'][name]} s in")

    infos = build.build_many(["packed_eh", "packed_ds", "packed_tb",
                              "family", "fused_eh"], verbose=True)
    result["build_s"] = round(time.time() - t0, 3)
    for lib, info in infos.items():
        say(f"built {os.path.relpath(info['path'], ROOT)} in "
            f"{result['build_s']} s (built={info['built']})")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {lib}: {line.strip()}")
    if args.only:
        only = {int(p) for p in args.only.split(",")}
        if not only <= {27, 28, 29, 30, 31, 32, 33, 34}:
            fail(f"--only takes phases 27 to 34, not {sorted(only)}")
        result["nvidia_smi"] = card_line()
        for phase, key, fn in ((27, "modes", modes_and_outputs),
                               (28, "far_field",
                                lambda: mie_far_field(dev)),
                               (29, "observability",
                                lambda: observability(dev)),
                               (30, "complex",
                                lambda: complex_fields(dev)),
                               (31, "ds_k_complex",
                                lambda: ds_k_and_complex(dev)),
                               (32, "sharded", lambda: sharded(dev)),
                               (33, "ds_sharded",
                                lambda: ds_sharded(dev)),
                               (34, "family_sharded",
                                lambda: family_sharded(dev))):
            if phase in only:
                t1 = time.time()
                result[key] = fn()
                result[f"phase_{phase}_s"] = time.time() - t1
        print(json.dumps(result), flush=True)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=1)
        return 0

    # ---- phase 1: kernels vs plain versions on the card ------------------
    cfg256 = config(EXAMPLE, ["--same-size", "256"])
    sim = seeded_sim(cfg256, dev, seed=1)
    err_e = one_launch_vs_plain(sim, packed.e_update,
                                packed.e_update_plain, "E")
    err_h = one_launch_vs_plain(sim, packed.h_update,
                                packed.h_update_plain, "H")
    say(f"one launch at 256^3 matches the plain version (E {err_e:.3e}, "
        f"H {err_h:.3e})")
    err_steps = kernel_vs_plain(cfg256, dev, 1, "256^3 TFSF+CPML")
    mie = ["--same-size", "128", "--eps-sphere-center-x", "64",
           "--eps-sphere-center-y", "64", "--eps-sphere-center-z", "64",
           "--eps-sphere-radius", "16", "--use-drude", "--eps-inf", "4.0",
           "--omega-p", "1e12", "--gamma-d", "5e10",
           "--drude-sphere-center-x", "64", "--drude-sphere-center-y",
           "64", "--drude-sphere-center-z", "64",
           "--drude-sphere-radius", "12", "--topology", "none"]
    err_mie = kernel_vs_plain(config(MIE, mie), dev, 2,
                              "128^3 eps sphere + Drude sphere")
    oblique = ["--same-size", "96", "--pml-sizex", "0", "--angle-teta",
               "30", "--angle-phi", "40", "--angle-psi", "15",
               "--point-source", "Ez"]
    err_obl = kernel_vs_plain(config(EXAMPLE, oblique), dev, 3,
                              "96^3 oblique TFSF + point source, y/z CPML")
    del sim
    err_tb = tb_vs_plain(cfg256, dev, 11, 1, "256^3 TFSF+CPML")
    err_tb_mie = tb_vs_plain(config(MIE, mie), dev, 12, STEPS_CMP,
                             "128^3 eps sphere + Drude sphere")
    err_tb_obl = tb_vs_plain(config(EXAMPLE, oblique), dev, 13, STEPS_CMP,
                             "96^3 oblique TFSF + point source, y/z CPML")
    err_tb_odd = tb_vs_plain(
        config(EXAMPLE, ["--same-size", "0", "--sizex", "100", "--sizey",
                         "90", "--sizez", "70"]), dev, 14, STEPS_CMP,
        "100x90x70 TFSF + xyz CPML")
    result["max_abs_err"] = {"e_update_one": err_e, "h_update_one": err_h,
                             "steps_256": err_steps, "steps_128_mie":
                             err_mie, "steps_96_oblique": err_obl,
                             "tb_one_256": err_tb, "tb_128_mie": err_tb_mie,
                             "tb_96_oblique": err_tb_obl,
                             "tb_100x90x70": err_tb_odd}

    # ---- phase 4: the ds kernels vs their plain versions ----------------
    eft_probe_check(dev)
    ds256 = config(PRECISION, ["--same-size", "256"])
    sim = seeded_ds_sim(ds256, dev, seed=4, warm=20)
    result["ds_line_terms"] = ds_line_terms_check(sim)
    err_ds = ds_one_step_vs_plain(sim)
    result["ds_pass_occupancy"] = packed_ds.occupancy()
    say(f"one ds step (line + pass) at 256^3 matches the plain step (max "
        f"abs err {max(err_ds.values()):.3e}, bit-exact: "
        f"{max(err_ds.values()) == 0.0}); pass kernels "
        + json.dumps(result["ds_pass_occupancy"]))
    del sim
    ds_spheres = ["--eps-sphere", "4.0", "--eps-sphere-center-x", "64",
                  "--eps-sphere-center-y", "64", "--eps-sphere-center-z",
                  "64", "--eps-sphere-radius", "16", "--use-drude",
                  "--eps-inf", "4.0", "--omega-p", "1e12", "--gamma-d",
                  "5e10", "--drude-sphere-center-x", "64",
                  "--drude-sphere-center-y", "64",
                  "--drude-sphere-center-z", "64",
                  "--drude-sphere-radius", "12"]
    result["max_abs_err"].update({
        "ds_step_one": err_ds,
        "ds_steps_128": ds_kernel_vs_plain(
            config(PRECISION, []), dev, 5, "ds 128^3 precision example"),
        "ds_steps_128_spheres": ds_kernel_vs_plain(
            config(PRECISION, ds_spheres), dev, 6,
            "ds 128^3 eps sphere + Drude sphere"),
        "ds_steps_96_point": ds_kernel_vs_plain(
            config(PRECISION, ["--same-size", "96", "--pml-sizex", "0",
                               "--point-source", "Ez"]), dev, 7,
            "ds 96^3 point source, no CPML on x"),
        "ds_steps_128_vacuum": ds_kernel_vs_plain(
            config(PRECISION, ["--no-use-pml", "--no-use-tfsf"]), dev, 8,
            "ds 128^3 vacuum", field_tol=DS_VACUUM_TOL)})
    ds_checks = [v for k, v in result["max_abs_err"].items()
                 if k.startswith("ds_step")]
    err_ds_pass = max(c["pass"] for c in ds_checks)
    err_ds_line = max([result["ds_line_terms"]["max_abs_err"]]
                      + [c["line"] for c in ds_checks])

    mark("phases 1, 4")
    # ---- phase 2: the main path through the CLI ---------------------------
    steps = cfg256.time_steps
    main = {}
    for n in (steps, steps + 1):
        main[n] = cli_main_path(n, cfg256)
    f32_fields = main[steps].pop("fields")
    main[steps + 1].pop("fields")
    launches = main[steps]["launches"]
    tail_launches = main[steps + 1]["launches"]
    want = {"tb_pass": steps // 2, "e_update": 0, "h_update": 0}
    if launches != want:
        fail(f"{steps} steps: kernel launches {launches} != {want}")
    want = {"tb_pass": steps // 2, "e_update": 1, "h_update": 1}
    if tail_launches != want:
        fail(f"{steps + 1} steps: kernel launches {tail_launches} != "
             f"{want}")
    result["main_path"] = main[steps]
    result["main_path_odd"] = main[steps + 1]

    # ---- phase 5: the ds main path through the CLI, and accuracy --------
    ds_dir = os.path.join(OUT_DIR, "ds")
    ds_cfg = config(PRECISION, [])
    ds_steps = ds_cfg.time_steps
    packed_ds.line_advance.launches = 0
    packed_ds.ds_pass.launches = packed_ds.ds_pass.kernels = 0
    torch.cuda.reset_peak_memory_stats()
    captured = _io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(captured):
        rc = cli.main(["--cmd-from-file", PRECISION, "--save-res",
                       str(ds_steps), "--check-finite", "--save-dir",
                       ds_dir])
    torch.cuda.synchronize()
    ds_wall = time.time() - t0
    ds_launches = {"line": packed_ds.line_advance.launches,
                   "pass": packed_ds.ds_pass.launches}
    log_txt = captured.getvalue()
    say("cli (float32x2): " + " | ".join(log_txt.strip().splitlines()))
    if rc != 0:
        fail(f"cli.main returned {rc} on {PRECISION}")
    if "step_kind=packed_ds_cuda" not in log_txt:
        fail("the CLI did not run the packed-ds CUDA step")
    if ds_launches != {"line": ds_steps, "pass": ds_steps}:
        fail(f"ds kernel calls {ds_launches} != {ds_steps} each")
    # kernels a step: the line's, and the pass's section kernels
    ds_kernels_per_step = (ds_launches["line"]
                           + packed_ds.ds_pass.kernels) / ds_steps
    if ds_kernels_per_step > 3:
        fail(f"the ds step launches {ds_kernels_per_step} kernels, not at "
             "most 3")
    ds_fields = {}
    for c in ("Ex", "Ey", "Ez", "Hx", "Hy", "Hz"):
        path = os.path.join(ds_dir, f"{c}_t{ds_steps:06d}.dat")
        if not os.path.exists(path):
            fail(f"missing dump {path}")
        ds_fields[c] = load_dat(path)
        if ds_fields[c].shape != ds_cfg.grid_shape \
                or str(ds_fields[c].dtype) != "float32" \
                or not bool((abs(ds_fields[c]) < float("inf")).all()):
            fail(f"{c}: bad ds dump (shape {ds_fields[c].shape}, dtype "
                 f"{ds_fields[c].dtype} or non-finite)")
    ds_peak = torch.cuda.max_memory_allocated()
    runs = {}
    for dtype, kind in (("float64", "plain"),
                        ("float32", "packed_tb_cuda")):
        rsim = Simulation(config(PRECISION, ["--dtype", dtype]), device=dev)
        if rsim.step_kind != kind:
            fail(f"{dtype} ran {rsim.step_kind}, not {kind}")
        t0 = time.time()
        rsim.run()
        rsim.block_until_ready()
        runs[dtype] = (rsim.fields(), time.time() - t0)
        del rsim
    ref64 = runs["float64"][0]
    rel_ds = rel_vs_f64(ds_fields, ref64)
    rel_f32 = rel_vs_f64(runs["float32"][0], ref64)
    result["ds_main_path"] = {
        "steps": ds_steps, "wall_s": ds_wall, "launches": ds_launches,
        "kernels_per_step": ds_kernels_per_step,
        "peak_mem_bytes": ds_peak, "rel_vs_f64": rel_ds,
        "f32_rel_vs_f64": rel_f32, "f64_wall_s": runs["float64"][1],
        "f32_wall_s": runs["float32"][1],
        "f32_rel_above_floor": rel_f32 > F32_REL_FLOOR}
    say(f"ds main path: {ds_steps} steps in {ds_wall:.2f} s, launches "
        f"{ds_launches}; rel vs f64: float32x2 {rel_ds:.3e} (bar "
        f"{DS_REL_BAR}), float32 {rel_f32:.3e} (expected above "
        f"{F32_REL_FLOOR})")
    if not rel_ds <= DS_REL_BAR:
        fail(f"float32x2 rel vs f64 {rel_ds:.3e} > {DS_REL_BAR}")
    # phase 31's complex run of the same argv: its re parts against these
    # dumps, its accuracy against this float64 run
    phase5_ds = (ds_fields, ref64)
    del ds_fields, runs, ref64

    # ---- phase 3: times at 256^3 -----------------------------------------
    sim = Simulation(cfg256, device=dev)
    sim.advance(steps)             # a realistic mid-run state
    carry = sim._carry
    step = packed.make_packed_step(sim.static, dev)
    cc = step.prepare(sim.coeffs)
    reps = 50
    e_ms = timed(lambda: packed.e_update(carry["E"], carry["H"],
                                         carry.get("J"), carry["psE"],
                                         cc["E"]), reps)
    h_ms = timed(lambda: packed.h_update(carry["H"], carry["E"],
                                         carry["psH"], cc["H"]), reps)
    e_plain = timed(lambda: packed.e_update_plain(
        carry["E"], carry["H"], carry.get("J"), carry["psE"], cc["E"]), 5)
    h_plain = timed(lambda: packed.h_update_plain(
        carry["H"], carry["E"], carry["psH"], cc["H"]), 5)
    plain_step = packed.make_packed_step(sim.static, dev, plain=True)
    step_ms = timed(lambda: step(carry, cc), reps)
    plain_step_ms = timed(lambda: plain_step(carry, cc), 5)
    torch.cuda.reset_peak_memory_stats()
    sim.advance(10)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    cells = 256 ** 3
    b_e = family_bytes(carry, cc, "E")
    b_h = family_bytes(carry, cc, "H")
    bound = {}
    for fam, nbytes in (("E", b_e), ("H", b_h)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = family_flops(carry, fam) / F32_FLOPS * 1e3
        bound[fam] = (max(t_bytes, t_ops),
                      "bytes" if t_bytes >= t_ops else "operations")
    vol = cells * 4
    step_bytes = 12 * vol + sum(2 * v.numel() * 4 for v in
                                list(carry["psE"].values())
                                + list(carry["psH"].values()))
    step_bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    result["times_256"] = {
        "e_update_ms": e_ms, "h_update_ms": h_ms,
        "kernel_ms_per_step": e_ms + h_ms, "step_ms": step_ms,
        "plain_e_ms": e_plain, "plain_h_ms": h_plain,
        "plain_step_ms": plain_step_ms,
        "mcells_per_s": cells / (step_ms * 1e-3) / 1e6,
        "step_bound_bytes": step_bytes, "step_bound_ms": step_bound_ms,
        "kernel_bound_share": step_bound_ms / (e_ms + h_ms),
        "peak_mem_bytes_advance": peak,
        "e_bound_ms": bound["E"][0], "h_bound_ms": bound["H"][0],
        "e_bytes": b_e, "h_bytes": b_h}
    say("times at 256^3: " + json.dumps(result["times_256"]))

    tb_step = packed_tb.make_packed_tb_step(sim.static, dev)
    tb_plain = packed_tb.make_packed_tb_step(sim.static, dev, plain=True)
    tcc = tb_step.prepare(sim.coeffs)
    spare = {k: clone_carry(v) for k, v in carry.items()
             if k in ("E", "H", "J", "psE", "psH")}
    _, terms, drive = packed_tb.generation_terms(sim.static, tcc["tb"],
                                                 carry["inc"], carry["t"])
    tb_ms = timed(lambda: packed_tb.tb_pass(carry, spare, tcc["tb"], terms,
                                            drive), reps)
    tb_plain_ms = timed(lambda: packed_tb.tb_pass_plain(
        carry, spare, tcc["tb"], terms, drive), 5)
    terms_ms = timed(lambda: packed_tb.generation_terms(
        sim.static, tcc["tb"], carry["inc"], carry["t"]), reps)
    tb_call_ms = timed(lambda: tb_step(carry, tcc), reps)
    tb_plain_call_ms = timed(lambda: tb_plain(carry, tcc), 5)
    nbytes, nops = tb_bytes(carry, tcc), tb_flops(carry, tcc)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_FLOPS * 1e3
    tb_bound = (max(t_bytes, t_ops),
                "bytes" if t_bytes >= t_ops else "operations")
    result["tb_times_256"] = {
        "tb_pass_ms": tb_ms, "plain_pass_ms": tb_plain_ms,
        "generation_terms_ms": terms_ms, "pass_call_ms": tb_call_ms,
        "step_ms": tb_call_ms / 2, "plain_step_ms": tb_plain_call_ms / 2,
        "mcells_per_s": cells / (tb_call_ms / 2 * 1e-3) / 1e6,
        "pass_bytes": nbytes, "pass_ops": nops, "bytes_ms": t_bytes,
        "ops_ms": t_ops, "bound_ms": tb_bound[0],
        "bound_share": tb_bound[0] / tb_ms,
        "packed_step_ms_same_call": step_ms}
    say("tb times at 256^3: " + json.dumps(result["tb_times_256"]))
    result["tb_report_256"] = tb_report("256^3, phase 3", tb_ms, tb_bound[0],
                                        e_ms + h_ms)
    result["packed_report"] = packed_report("phase 3")
    del sim, carry, cc, tcc, spare, terms
    sim = Simulation(cfg256, device=dev)
    sim.advance(20)
    result["tb_profile_256"] = profile_window(sim, 20)
    say("tb step at 256^3 under torch.profiler: "
        + json.dumps(result["tb_profile_256"]))
    del sim

    # ---- phase 6: ds times at 256^3 --------------------------------------
    sim = Simulation(ds256, device=dev)
    sim.advance(100)               # a wave on the incident line and grid
    result["ds_times_256"] = ds_times(sim, dev, 20, 2)
    dt6 = result["ds_times_256"]
    dt6["mcells_per_s"] = cells / (dt6["step_ms"] * 1e-3) / 1e6
    say("ds times at 256^3: " + json.dumps(result["ds_times_256"]))
    del sim
    sim = Simulation(ds_cfg, device=dev)
    sim.advance(20)
    result["ds_profile_128"] = profile_window(sim, 50)
    say("ds step at 128^3 under torch.profiler: "
        + json.dumps(result["ds_profile_128"]))
    del sim

    mark("phases 2, 3, 5, 6")
    # ---- phase 7: the lane-capable kernels vs plain and vs solo ----------
    c, r = "64", "12"
    lane_extra = ["--angle-teta", "30", "--angle-phi", "40", "--angle-psi",
                  "15", "--point-source", "Ez", "--use-drude", "--eps-inf",
                  "4.0", "--gamma-d", "5e10", "--drude-sphere-center-x", c,
                  "--drude-sphere-center-y", c, "--drude-sphere-center-z", c,
                  "--drude-sphere-radius", r]
    lanes128 = [config(MIE, mie_args(128, eps, lane_extra + [
        "--omega-p", wp, "--point-source-amplitude", amp]))
        for eps, wp, amp in (("2.0", "1e12", "1.0"), ("4.0", "2e12", "2.0"),
                             ("6.0", "5e11", "-0.5"))]
    bsim = lane_batch(lanes128, dev)
    seed_leaves(bsim._carry, dev, 21)
    err_lane128 = lane_kernels_check(
        bsim, dev, "3 lanes at 128^3 (eps and Drude spheres, oblique TFSF, "
        "point source)")
    del bsim

    # ---- phase 8: lane-capable kernel times at 256^3, B = 1, 2, 4 --------
    result["batch_times_256"] = {}
    for lanes in (1, 2, 4):
        bsim = lane_batch([cfg256] * lanes, dev)
        bsim.advance(steps)            # a realistic mid-run state
        bt = lane_times(bsim, dev, reps, 3)
        result["batch_times_256"][lanes] = bt
        say(f"lane-capable times at 256^3, {lanes} lane(s): "
            + json.dumps(bt))
        bt["tb_report"] = tb_report(
            f"256^3, {lanes} lane(s), phase 8", bt["tb_pass_ms"],
            bt["tb_bound_ms"], bt["e_update_ms"] + bt["h_update_ms"])
        del bsim

    # ---- phase 9: the main path's shapes, and the odd step's tail --------
    cfgs512 = [config(MIE, ["--eps-sphere", e])
               for e in ("2.0", "4.0", "6.0", "9.0")]
    packed.e_update.launches = 0
    packed.h_update.launches = 0
    packed_tb.tb_pass.launches = 0
    t0 = time.time()
    bsim = Simulation.run_batch(cfgs512, time_steps=1, device=dev)
    torch.cuda.synchronize()
    tail_run = {"wall_s": time.time() - t0, "launches": {
        "tb_pass": packed_tb.tb_pass.launches,
        "e_update": packed.e_update.launches,
        "h_update": packed.h_update.launches}}
    if bsim.step_kind != "packed_tb_cuda" or bsim.batch_fallback \
            or tail_run["launches"] != {"tb_pass": 0, "e_update": 1,
                                        "h_update": 1} \
            or bsim.lane_finite != [True] * 4:
        fail(f"run_batch, 4 Mie lanes at 512^3, 1 step: {bsim.step_kind} "
             f"{bsim.batch_fallback} launches {tail_run['launches']} "
             f"lanes {bsim.lane_finite}")
    say(f"run_batch (4 Mie lanes at 512^3, 1 step: the lane-capable packed "
        f"tail): {json.dumps(tail_run)}")
    result["batch_tail_512"] = tail_run
    seed_leaves(bsim._carry, dev, 31)
    err_lane512 = lane_kernels_check(bsim, dev, "4 Mie lanes at 512^3")
    times512 = lane_times(bsim, dev, 5, 1)
    result["batch_times_512"] = times512
    say("lane-capable times at 512^3, 4 Mie lanes: " + json.dumps(times512))
    times512["tb_report"] = tb_report(
        "512^3, 4 Mie lanes, phase 9", times512["tb_pass_ms"],
        times512["tb_bound_ms"],
        times512["e_update_ms"] + times512["h_update_ms"])
    del bsim
    torch.cuda.empty_cache()

    # ---- phase 10: the batch main path through the CLI --------------------
    spec_dir = os.path.join(OUT_DIR, "batch_specs")
    os.makedirs(spec_dir, exist_ok=True)
    with open(MIE) as f:
        mie_text = f.read()
    paths = []
    for eps in ("2.0", "4.0", "6.0", "9.0"):
        path = os.path.join(spec_dir, f"sphere3D_mie_eps{eps}.txt")
        with open(path, "w") as f:
            f.write(f"{mie_text}\n--eps-sphere {eps}\n")
        paths.append(path)
    mie_steps = cfgs512[0].time_steps
    batch_main = batch_cli_path(paths, "4 Mie lanes at 512^3")
    want = {"tb_pass": mie_steps // 2, "e_update": mie_steps % 2,
            "h_update": mie_steps % 2}
    if batch_main["launches"] != want:
        fail(f"batch main path: launches {batch_main['launches']} != "
             f"{want}")
    result["batch_main_path"] = batch_main
    say(f"batch main path: 4 lanes x {mie_steps} steps, launches "
        f"{batch_main['launches']}, "
        f"{batch_main['mcells_per_s_aggregate']} Mcells/s aggregate, peak "
        f"{batch_main['peak_mem_bytes'] / 1e9:.3f} GB")

    mark("phases 7-10")
    # ---- phase 11: the ladder's kernels vs their plain versions ---------
    ladder_err = {}
    mie512 = config(MIE, [])
    for label, cfg_l, seed in (
            ("256^3 TFSF+CPML", cfg256, 41),
            ("128^3 eps + Drude spheres, point source, TFSF",
             config(MIE, mie + ["--point-source", "Ez"]), 42),
            ("512^3 Mie example", mie512, 43)):
        for k, v in ladder_vs_plain(cfg_l, dev, seed, label).items():
            ladder_err[k] = max(ladder_err.get(k, 0.0), v)
    result["max_abs_err"].update(
        {f"ladder_{k}": v for k, v in ladder_err.items()})

    # ---- phase 12: the ladder's main path through the CLI ----------------
    rungs = (("pallas3d_cuda", ("FDTD3D_NO_PACKED", "FDTD3D_NO_FUSED")),
             ("fused_cuda", ("FDTD3D_NO_PACKED", "FDTD3D_FORCE_FUSED")))
    ladder_main, ladder_fields = {}, {}
    for label, argv, cfg_l in (
            ("vacuum256", ["--cmd-from-file", EXAMPLE, "--same-size",
                           "256"], cfg256),
            ("mie512", ["--cmd-from-file", MIE], mie512)):
        for kind, names in rungs:
            rec, fields = ladder_cli(f"{label}_{kind}", argv, names, kind,
                                     cfg_l)
            n = cfg_l.time_steps
            sections = fused_sections_per_step(build_static(cfg_l), dev)
            two = kind == "pallas3d_cuda"
            want = {"e_family": n if two else 0, "h_family": n if two else 0,
                    "family_kernels": n * family_sections_per_step(
                        build_static(cfg_l), dev) if two else 0,
                    "fused_eh": n if kind == "fused_cuda" else 0,
                    "fused_eh_kernels":
                        n * sections if kind == "fused_cuda" else 0,
                    "tb_pass": 0, "e_update": 0, "h_update": 0}
            if rec["launches"] != want:
                fail(f"{label} {kind}: launches {rec['launches']} != {want}")
            if label == "vacuum256" \
                    and not rec["tfsf_leakage"] <= 10 * REF_LEAKAGE:
                fail(f"{label} {kind}: TFSF leakage "
                     f"{rec['tfsf_leakage']:.3e} exceeds 10x the "
                     f"reference's {REF_LEAKAGE:.3e}")
            ladder_main[f"{label}_{kind}"] = rec
            ladder_fields[kind] = fields
            say(f"ladder main path {label} {kind}: {json.dumps(rec)}")
        rel = rel_fields(ladder_fields["fused_cuda"],
                         ladder_fields["pallas3d_cuda"])
        ladder_main[f"{label}_fused_vs_pallas3d_rel"] = rel
        say(f"{label}: fused vs two-pass dumps, rel {rel:.3e} of the "
            f"family max (gate {LADDER_REL})")
        if not rel < LADDER_REL:
            fail(f"{label}: the fused and two-pass runs disagree: rel "
                 f"{rel:.3e} >= {LADDER_REL}")
        ladder_fields.clear()
        for kind, _ in rungs:
            shutil.rmtree(os.path.join(OUT_DIR, f"ladder_{label}_{kind}"),
                          ignore_errors=True)
    result["ladder_main_path"] = ladder_main

    # ---- phase 13: the ladder's same-call times, and its profile ----------
    t256, e256 = ladder_times(cfg256, dev, steps, reps, 2, "256^3")
    t512, e512 = ladder_times(mie512, dev, 200, 10, 1, "512^3 Mie")
    result["ladder_times_256"], result["ladder_times_512"] = t256, t512
    result["family_256"] = family_report("256^3, phase 13", t256)
    result["family_512"] = family_report("512^3 Mie, phase 13", t512)
    for k in ladder_err:
        ladder_err[k] = max(ladder_err[k], e256[k], e512[k])
    result["max_abs_err"].update(
        {f"ladder_{k}": v for k, v in ladder_err.items()})
    for kind, names in rungs:
        with ladder_env(*names):
            sim = Simulation(cfg256, device=dev)
            sim.advance(20)
            result[f"ladder_profile_256_{kind}"] = prof = profile_window(
                sim, 20)
            del sim
        say(f"{kind} step at 256^3 under torch.profiler: "
            + json.dumps(prof))
        if prof["launches_per_step"] > LADDER_LAUNCHES:
            fail(f"the {kind} step at 256^3 launched "
                 f"{prof['launches_per_step']} kernels a step (at most "
                 f"{LADDER_LAUNCHES})")

    mark("phases 11-13")
    # ---- phase 14: the bf16 kernels vs their plain versions --------------
    mie128 = mie + ["--point-source", "Ez", "--angle-teta", "30",
                    "--angle-phi", "40", "--angle-psi", "15"]
    bf16_err, bf16_steps_err = bf16_kernels_vs_plain(dev, mie128)
    result["max_abs_err"].update(
        {f"bf16_{k}_steps_128": v for k, v in bf16_steps_err.items()})

    # ---- phase 15: the bf16 main path through the CLI --------------------
    bf16_main = bf16_main_paths(cfg256, steps, f32_fields)
    result["bf16_main_path"] = bf16_main[steps]
    result["bf16_main_path_odd"] = bf16_main[steps + 1]

    # ---- phase 16: bf16 vs f32 times at 256^3, the bf16 step's profile --
    cfg256_16 = config(EXAMPLE, ["--same-size", "256"] + BF16)
    t16, e16 = bf16_times(cfg256, cfg256_16, dev, steps, reps, 3, "256^3")
    result["bf16_times_256"] = t16
    sim = Simulation(cfg256_16, device=dev)
    sim.advance(20)
    result["bf16_profile_256"] = profile_window(sim, 20)
    say("bf16 tb step at 256^3 under torch.profiler: "
        + json.dumps(result["bf16_profile_256"]))
    del sim

    mark("phases 14-16")
    # ---- phase 17: the ladder in bf16: the CLI at 256^3, Mie 512^3 times -
    result["bf16_ladder_main_path"] = bf16_ladder = bf16_ladder_cli(
        cfg256, f32_fields, dev)
    del f32_fields
    t16m, e16m = bf16_times(mie512, config(MIE, BF16), dev, 200, 10, 1,
                            "512^3 Mie")
    result["bf16_times_512"] = t16m
    for k in bf16_err:
        bf16_err[k] = max(bf16_err[k], e16[k], e16m[k])
    result["max_abs_err"].update(
        {f"bf16_{k}_one": v for k, v in bf16_err.items()})

    # ---- phase 18: bf16 lanes: vs plain and solo, times, the CLI --------
    lane_flags = [mie_args(128, eps, lane_extra + [
        "--omega-p", wp, "--point-source-amplitude", amp] + BF16)
        for eps, wp, amp in (("2.0", "1e12", "1.0"), ("4.0", "2e12", "2.0"),
                             ("6.0", "5e11", "-0.5"))]
    bsim = lane_batch([config(MIE, f) for f in lane_flags], dev)
    seed_leaves(bsim._carry, dev, 61)
    err_lane16 = lane_kernels_check(
        bsim, dev, "3 bf16 lanes at 128^3 (eps and Drude spheres, oblique "
        "TFSF, point source)", TB_BF16_TOL, BF16_TOL)
    del bsim
    bsim = lane_batch([cfg256_16] * 4, dev)
    bsim.advance(steps)
    result["bf16_batch_times_256"] = bt16 = lane_times(bsim, dev, reps, 3)
    say("bf16 lane-capable times at 256^3, 4 lanes: " + json.dumps(bt16))
    del bsim
    paths = []
    for q, flags in enumerate(lane_flags):
        path = os.path.join(spec_dir, f"sphere3D_mie_bf16_lane{q}.txt")
        with open(path, "w") as f:
            f.write(f"{mie_text}\n{' '.join(flags)}\n--time-steps 41\n")
        paths.append(path)
    bf16_batch = batch_cli_path(paths, "3 bf16 lanes at 128^3")
    if bf16_batch["launches"] != {"tb_pass": 20, "e_update": 1,
                                  "h_update": 1}:
        fail(f"bf16 batch main path: launches {bf16_batch['launches']}")
    result["bf16_batch_main_path"] = bf16_batch

    # ---- phase 19: capacity at 1024^3, f32 and bf16 ---------------------
    result["capacity_1024"] = {dt: capacity_run(1024, dt, 20, dev)
                               for dt in ("float32", "bfloat16")}

    mark("phases 17-19")
    # ---- phase 20 (C1): the compensated example through the CLI ---------
    result["compensated_example"] = comp_ex = compensated_example(dev)
    mark("phase 20")
    # ---- phase 21 (C2): the compensated step at 256^3 -------------------
    result["compensated_times"] = comp_t = compensated_times(dev, reps, 2)
    mark("phase 21")
    # ---- phase 22 (C3): the cavity gate through the compensated kernel --
    result["cavity"] = cavity_check(dev)
    mark("phase 22")
    # ---- phase 23 (C4): the double-negative sphere at 512^3 -------------
    result["dng_512"] = dng = {dt: dng_mie(dev, dt, 200, 10, 1)
                               for dt in ("float32", "bfloat16")}
    mark("phase 23")
    # ---- phase 24 (C5): K down the ladder at 256^3, and K lanes ---------
    dng_l, dng_l_err = dng_ladder(dev, 200, reps, 2)
    result["dng_ladder_256"] = dng_l
    result["k_lanes_128"] = k_lanes = drude_m_lanes(dev)
    mark("phase 24")
    # ---- phase 25 (C6): compensated lanes at 128^3 ---------------------
    result["comp_lanes_128"] = comp_lanes = compensated_lanes(dev)
    mark("phase 25")
    # ---- phase 26: durable runs: checkpoints, resume, the supervisor ----
    result["durable"] = durable_runs(dev)
    mark("phase 26")
    # ---- phase 27: every scheme mode and every output of the CLI --------
    result["modes"] = modes_and_outputs()
    mark("phase 27")
    # ---- phase 28: the Mie far field (--ntff) on the tb and packed twins
    result["far_field"] = mie_far_field(dev)
    mark("phase 28")
    # ---- phase 29: health counters, the telemetry sink, profiling -------
    result["observability"] = observability(dev)
    mark("phase 29")
    # ---- phase 30: complex fields as paired real legs on the packed twin -
    result["complex"] = cplx = complex_fields(dev)
    mark("phase 30")
    # ---- phase 31: K in the float32x2 kernel, complex float32x2 legs ----
    result["ds_k_complex"] = dsk = ds_k_and_complex(dev, *phase5_ds)
    del phase5_ds
    mark("phase 31")
    # ---- phase 32: domain decomposition, the sharded packed step --------
    result["sharded"] = shd = sharded(dev)
    mark("phase 32")
    # ---- phase 33: float32x2 on a decomposed grid, the sharded ds step ---
    result["ds_sharded"] = dsh = ds_sharded(dev)
    mark("phase 33")
    # ---- phase 34: the sharded two-pass family kernels ------------------
    result["family_sharded"] = fsh = family_sharded(dev)
    mark("phase 34")
    result["max_abs_err"].update({
        "compensated": max(comp_ex["max_abs_err"].values()),
        "dng_512": {dt: v["max_abs_err"] for dt, v in dng.items()},
        "dng_ladder_256": dng_l_err, "k_lanes_128": k_lanes["max_abs_err"],
        "comp_lanes_128": comp_lanes["max_abs_err"],
        "complex": cplx["max_abs_err"],
        "ds_k": dsk["max_abs_err"],
        "ds_k_256": {k: dsk["times"][k]["max_abs_err"]
                     for k in ("k", "no_k")},
        "complex_ds": dsk["complex_times"]["max_abs_err"]})
    result["bf16_stats"] = BF16_STATS

    card = card_line()
    result["nvidia_smi"] = card
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)

    src = "fdtd3d_torch/csrc/packed_eh.cu"
    ds_src = "fdtd3d_torch/csrc/packed_ds.cu"
    tb_src = "fdtd3d_torch/csrc/packed_tb.cu"
    kernels = [
        {"name": "packed_tb.pass", "route": "cuda", "source": tb_src,
         "replaces": "fdtd3d_tpu/ops/pallas_packed_tb.py:900",
         "launches": launches["tb_pass"], "max_abs_err": err_tb,
         "ms": tb_ms, "plain_ms": tb_plain_ms, "bound_ms": tb_bound[0],
         "bound_by": tb_bound[1], "library_ms": None},
        {"name": "packed_eh.e_update", "route": "cuda", "source": src,
         "replaces": "fdtd3d_tpu/ops/pallas_packed.py:694",
         "launches": tail_launches["e_update"], "max_abs_err": err_e,
         "ms": e_ms, "plain_ms": e_plain, "bound_ms": bound["E"][0],
         "bound_by": bound["E"][1], "library_ms": None},
        {"name": "packed_eh.h_update", "route": "cuda", "source": src,
         "replaces": "fdtd3d_tpu/ops/pallas_packed.py:694",
         "launches": tail_launches["h_update"], "max_abs_err": err_h,
         "ms": h_ms, "plain_ms": h_plain, "bound_ms": bound["H"][0],
         "bound_by": bound["H"][1], "library_ms": None},
        {"name": "packed_ds.pass", "route": "cuda", "source": ds_src,
         "replaces": "fdtd3d_tpu/ops/pallas_packed_ds.py:429",
         "launches": ds_launches["pass"], "max_abs_err": err_ds_pass,
         "ms": dt6["pass_ms"], "plain_ms": dt6["pass_plain_ms"],
         "bound_ms": dt6["pass_bound_ms"], "bound_by": dt6["pass_bound_by"],
         "library_ms": None},
        {"name": "packed_ds.line", "route": "cuda", "source": ds_src,
         "replaces": "fdtd3d_tpu/ops/tfsf.py:235",
         "launches": ds_launches["line"], "max_abs_err": err_ds_line,
         "ms": dt6["line_ms"], "plain_ms": dt6["line_plain_ms"],
         "bound_ms": dt6["line_bound_ms"], "bound_by": dt6["line_bound_by"],
         "library_ms": None},
        {"name": "packed_tb.pass[4 lanes]", "route": "cuda",
         "source": tb_src,
         "replaces": "fdtd3d_tpu/ops/pallas_packed_tb.py:900",
         "launches": batch_main["launches"]["tb_pass"],
         "max_abs_err": max(err_lane128[0], err_lane512[0]),
         "ms": times512["tb_pass_ms"], "plain_ms": times512["tb_plain_ms"],
         "bound_ms": times512["tb_bound_ms"],
         "bound_by": times512["tb_bound_by"], "library_ms": None},
        {"name": "packed_eh.e_update[4 lanes]", "route": "cuda",
         "source": src,
         "replaces": "fdtd3d_tpu/ops/pallas_packed.py:537",
         "launches": tail_run["launches"]["e_update"],
         "max_abs_err": max(err_lane128[1], err_lane512[1]),
         "ms": times512["e_update_ms"], "plain_ms": times512["e_plain_ms"],
         "bound_ms": times512["e_bound_ms"],
         "bound_by": times512["e_bound_by"], "library_ms": None},
        {"name": "packed_eh.h_update[4 lanes]", "route": "cuda",
         "source": src,
         "replaces": "fdtd3d_tpu/ops/pallas_packed.py:537",
         "launches": tail_run["launches"]["h_update"],
         "max_abs_err": max(err_lane128[1], err_lane512[1]),
         "ms": times512["h_update_ms"], "plain_ms": times512["h_plain_ms"],
         "bound_ms": times512["h_bound_ms"],
         "bound_by": times512["h_bound_by"], "library_ms": None},
    ]
    fam_src = "fdtd3d_torch/csrc/family.cu"
    main_launches = {k: sum(rec["launches"][k] for key, rec in
                            ladder_main.items() if key.endswith("_cuda"))
                     for k in ("e_family", "h_family", "fused_eh")}
    for kname, key, source, replaces in (
            ("family.e_family", "e_family", fam_src,
             "fdtd3d_tpu/ops/pallas3d.py:293"),
            ("family.h_family", "h_family", fam_src,
             "fdtd3d_tpu/ops/pallas3d.py:293"),
            ("fused_eh.pass", "fused_eh", "fdtd3d_torch/csrc/fused_eh.cu",
             "fdtd3d_tpu/ops/pallas_fused.py:423")):
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": main_launches[key],
            "max_abs_err": ladder_err[key],
            "ms": t256.get(f"{key}_launch_ms", t256[f"{key}_ms"]),
            "plain_ms": t256[f"{key}_plain_ms"],
            "bound_ms": t256[f"{key}_bound_ms"],
            "bound_by": t256[f"{key}_bound_by"], "library_ms": None})
    mie_run = ladder_main["mie512_pallas3d_cuda"]["launches"]
    for key in ("e_family", "h_family"):
        kernels.append({
            "name": f"family.{key}[Mie 512]", "route": "cuda",
            "source": fam_src, "replaces": "fdtd3d_tpu/ops/pallas3d.py:293",
            "launches": mie_run[key], "max_abs_err": ladder_err[key],
            "ms": t512[f"{key}_launch_ms"],
            "plain_ms": t512[f"{key}_plain_ms"],
            "bound_ms": t512[f"{key}_bound_ms"],
            "bound_by": t512[f"{key}_bound_by"], "library_ms": None})
    for kname, key, source, replaces, launches_n, bt in (
            ("packed_tb.pass[bf16]", "tb_pass", tb_src,
             "fdtd3d_tpu/ops/pallas_packed_tb.py:900",
             bf16_main[steps]["launches"]["tb_pass"], t16),
            ("packed_eh.e_update[bf16]", "e_update", src,
             "fdtd3d_tpu/ops/pallas_packed.py:694",
             bf16_main[steps + 1]["launches"]["e_update"], t16),
            ("packed_eh.h_update[bf16]", "h_update", src,
             "fdtd3d_tpu/ops/pallas_packed.py:694",
             bf16_main[steps + 1]["launches"]["h_update"], t16),
            ("family.e_family[bf16]", "e_family", fam_src,
             "fdtd3d_tpu/ops/pallas3d.py:293",
             bf16_ladder["pallas3d_cuda"]["launches"]["e_family"], t16),
            ("family.h_family[bf16]", "h_family", fam_src,
             "fdtd3d_tpu/ops/pallas3d.py:293",
             bf16_ladder["pallas3d_cuda"]["launches"]["h_family"], t16),
            ("fused_eh.pass[bf16]", "fused_eh",
             "fdtd3d_torch/csrc/fused_eh.cu",
             "fdtd3d_tpu/ops/pallas_fused.py:423",
             bf16_ladder["fused_cuda"]["launches"]["fused_eh"], t16)):
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_n,
            "max_abs_err": bf16_err[key],
            "ms": bt.get(f"{key}_bf16_launch_ms", bt[f"{key}_bf16_ms"]),
            "plain_ms": bt[f"{key}_bf16_plain_ms"],
            "bound_ms": bt[f"{key}_bf16_bound_ms"],
            "bound_by": bt[f"{key}_bf16_bound_by"], "library_ms": None})
    for kname, key, source, replaces, launches_n, err_n in (
            ("packed_tb.pass[bf16 lanes]", "tb", tb_src,
             "fdtd3d_tpu/ops/pallas_packed_tb.py:900",
             bf16_batch["launches"]["tb_pass"], err_lane16[0]),
            ("packed_eh.e_update[bf16 lanes]", "e", src,
             "fdtd3d_tpu/ops/pallas_packed.py:537",
             bf16_batch["launches"]["e_update"], err_lane16[1]),
            ("packed_eh.h_update[bf16 lanes]", "h", src,
             "fdtd3d_tpu/ops/pallas_packed.py:537",
             bf16_batch["launches"]["h_update"], err_lane16[1])):
        ms_key = "tb_pass_ms" if key == "tb" else f"{key}_update_ms"
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches_n,
            "max_abs_err": err_n, "ms": bt16[ms_key],
            "plain_ms": bt16[f"{key}_plain_ms"],
            "bound_ms": bt16[f"{key}_bound_ms"],
            "bound_by": bt16[f"{key}_bound_by"], "library_ms": None})
    comp_launches = comp_ex["cli"]["launches"]
    for fam in ("e", "h"):
        kernels.append({
            "name": f"packed_eh.{fam}_update[compensated]", "route": "cuda",
            "source": src, "replaces": "fdtd3d_tpu/ops/pallas_packed.py:694",
            "launches": comp_launches[f"{fam}_update"],
            "max_abs_err": result["max_abs_err"]["compensated"],
            "ms": comp_t[f"{fam}_update_comp_ms"],
            "plain_ms": comp_t[f"{fam}_update_comp_plain_ms"],
            "bound_ms": comp_t[f"{fam}_update_comp_bound_ms"],
            "bound_by": comp_t[f"{fam}_update_comp_bound_by"],
            "library_ms": None})
    for dt, tag in (("float32", "K"), ("bfloat16", "K bf16")):
        d = dng[dt]
        for fam in ("e", "h"):
            kernels.append({
                "name": f"packed_eh.{fam}_update[{tag}]", "route": "cuda",
                "source": src,
                "replaces": "fdtd3d_tpu/ops/pallas_packed.py:694",
                "launches": d["launches"][f"{fam}_update"],
                "max_abs_err": d["max_abs_err"],
                "ms": d[f"{fam}_update_ms"], "plain_ms": d[f"{fam}_plain_ms"],
                "bound_ms": d[f"{fam}_bound_ms"],
                "bound_by": d[f"{fam}_bound_by"], "library_ms": None})
        for kname, key, source, replaces, cli_key in (
                ("family.e_family", "e_family", fam_src,
                 "fdtd3d_tpu/ops/pallas3d.py:293", "pallas3d"),
                ("family.h_family", "h_family", fam_src,
                 "fdtd3d_tpu/ops/pallas3d.py:293", "pallas3d"),
                ("fused_eh.pass", "fused_eh", "fdtd3d_torch/csrc/fused_eh.cu",
                 "fdtd3d_tpu/ops/pallas_fused.py:423", "fused")):
            kernels.append({
                "name": f"{kname}[{tag}]", "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": dng_l[f"cli_{cli_key}_{dt}"]["launches"][key],
                "max_abs_err": dng_l_err[dt][key],
                "ms": dng_l.get(f"{key}_{dt}_launch_ms",
                                dng_l[f"{key}_{dt}_ms"]),
                "plain_ms": dng_l[f"{key}_{dt}_plain_ms"],
                "bound_ms": dng_l[f"{key}_{dt}_bound_ms"],
                "bound_by": dng_l[f"{key}_{dt}_bound_by"],
                "library_ms": None})
    for tag, rec in (("K lanes", k_lanes), ("compensated lanes",
                                            comp_lanes)):
        for fam in ("e", "h"):
            kernels.append({
                "name": f"packed_eh.{fam}_update[{tag}]", "route": "cuda",
                "source": src,
                "replaces": "fdtd3d_tpu/ops/pallas_packed.py:537",
                "launches": rec["main_path"]["launches"][f"{fam}_update"],
                "max_abs_err": rec["max_abs_err"],
                "ms": rec[f"{fam}_update_ms"],
                "plain_ms": rec[f"{fam}_plain_ms"],
                "bound_ms": rec[f"{fam}_bound_ms"],
                "bound_by": rec[f"{fam}_bound_by"], "library_ms": None})
    ct = cplx["times"]
    for fam in ("e", "h"):
        kernels.append({
            "name": f"packed_eh.{fam}_update[complex legs]", "route": "cuda",
            "source": src, "replaces": "fdtd3d_tpu/ops/pallas_packed.py:694",
            "launches": cplx["main_path"]["launches"][f"{fam}_update"],
            "max_abs_err": max(cplx["max_abs_err"].values()),
            "ms": ct[f"{fam}_update_ms"], "plain_ms": ct[f"{fam}_plain_ms"],
            "bound_ms": ct[f"{fam}_bound_ms"],
            "bound_by": ct[f"{fam}_bound_by"], "library_ms": None})
    dk, cm = dsk["times"], dsk["complex_main_path"]
    leg = dsk["complex_times"]["leg"]
    for kname, launches_n, err_n, t in (
            ("packed_ds.pass[K]", dk["launches"]["ds_pass"],
             max([e["pass"] for e in dsk["max_abs_err"].values()]
                 + [dk["k"]["max_abs_err"]["pass"]]), dk["k"]),
            ("packed_ds.pass[complex legs]", cm["launches"]["ds_pass"],
             dsk["complex_times"]["max_abs_err"]["pass"], leg)):
        kernels.append({
            "name": kname, "route": "cuda", "source": ds_src,
            "replaces": "fdtd3d_tpu/ops/pallas_packed_ds.py:429",
            "launches": launches_n, "max_abs_err": err_n,
            "ms": t["pass_ms"], "plain_ms": t["pass_plain_ms"],
            "bound_ms": t["pass_bound_ms"], "bound_by": t["pass_bound_by"],
            "library_ms": None})
    kernels.append({
        "name": "packed_ds.line[complex legs]", "route": "cuda",
        "source": ds_src, "replaces": "fdtd3d_tpu/ops/tfsf.py:235",
        "launches": cm["launches"]["ds_line"],
        "max_abs_err": dsk["complex_times"]["max_abs_err"]["line"],
        "ms": leg["line_ms"], "plain_ms": leg["line_plain_ms"],
        "bound_ms": leg["line_bound_ms"], "bound_by": leg["line_bound_by"],
        "library_ms": None})
    st = shd["times"]
    for fam in ("e", "h"):
        kernels.append({
            "name": f"packed_eh.{fam}_update[sharded]", "route": "cuda",
            "source": src, "replaces": "fdtd3d_tpu/ops/pallas_packed.py:1304",
            "launches": shd["main_path"]["2x2x1"]["launches"][
                f"{fam}_update_sharded"],
            "max_abs_err": max(v[fam.upper()] for v in
                               shd["max_abs_err"].values()),
            "ms": st[f"{fam}_update_ms"], "plain_ms": st[f"{fam}_plain_ms"],
            "bound_ms": st[f"{fam}_bound_ms"],
            "bound_by": st[f"{fam}_bound_by"], "library_ms": None})
    dt33 = dsh["times"]["precision"]
    for kname, key, err_key, replaces in (
            ("packed_ds.pass[sharded]", "ds_pass_sharded", "pass",
             "fdtd3d_tpu/ops/pallas_packed_ds.py:429"),
            ("packed_ds.hi_edge_h[sharded]", "hi_edge_h", "hi_edge",
             "fdtd3d_tpu/ops/pallas_packed_ds.py:1237")):
        ms_key = "pass" if err_key == "pass" else "hi_edge"
        kernels.append({
            "name": kname, "route": "cuda", "source": ds_src,
            "replaces": replaces,
            "launches": dsh["main_path"]["precision_2x2x1"]["launches"][key],
            "max_abs_err": max(v[err_key] for v in
                               dsh["max_abs_err"].values()),
            "ms": dt33[f"{ms_key}_ms"], "plain_ms": dt33[f"{ms_key}_plain_ms"],
            "bound_ms": dt33[f"{ms_key}_bound_ms"],
            "bound_by": dt33[f"{ms_key}_bound_by"], "library_ms": None})
    ft = fsh["times"]
    for key in ("e_family", "h_family"):
        kernels.append({
            "name": f"family.{key}[sharded]", "route": "cuda",
            "source": fam_src, "replaces": "fdtd3d_tpu/ops/pallas3d.py:293",
            "launches": fsh["main_path"]["vacuum 256^3 2x2x1"]["launches"][
                f"{key}_sharded"],
            "max_abs_err": max(v[key[0].upper()] for v in
                               fsh["max_abs_err"].values()),
            "ms": ft[f"{key}_launch_ms"], "plain_ms": ft[f"{key}_plain_ms"],
            "bound_ms": ft[f"{key}_bound_ms"],
            "bound_by": ft[f"{key}_bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
