"""Smoke run of the PyTorch/CUDA port on one GPU (path j takes every card
the machine has, up to four), at the flagship width.

Run from the repository root on a machine with an NVIDIA H100 (no
arguments):

    python3 chip_smoke.py

It imports nothing of JAX or the JAX package.  In order it

1. builds every CUDA kernel of the port from ``gpbayestools_hic_tpu_torch/csrc``;
2. phase "training": builds the flagship calibration problem with the port
   itself, as the JAX package's bench fits it (17 parameters, 9 emulators x
   4 PCs = 36 RBF GPs on 1000 design points, 544 observables; one joint
   fit of the 36 GPs on the card in float32, ``gp_maxiter=30``, seed 0),
   logs the fit's wall time, L-BFGS iterations, line-search trials,
   converged lanes, host synchronisations and peak device memory, and
   fails unless every GP's fitted LML is finite and no lower than at the
   initialization, float32 ``gp_nll`` and its gradient at the fitted point
   match float64 (``TOL_NLL32``), and, for GP 0 of emulators 0, 3 and 8,
   the port's float64 fit at ``maxiter=200`` reaches scipy's float64
   L-BFGS-B optimum within 0.2 and its float32 fit lands where the JAX
   package's float32 fit does (``JAX_F32_LML``; the float32 fits' distance
   to scipy's optimum is printed);
3. prints, from ``cuobjdump -sass`` of the built predict and MVN
   libraries where the toolkit has it, the HGMMA (wgmma), UTMALDG (TMA)
   and HMMA (mma.sync) instructions of each kernel (evidence, not a
   gate); checks
   each kernel against its plain PyTorch version (on the fitted
   chain, as everything up to 5) at the shapes its
   path gives it and times kernel, plain version, library yardsticks and
   the bound: the fused predict forward and both backwards at one
   emulator's shape (b = 4, n = 1000, d = 17, m = 1024; the forward
   against its plain version in float32 and in float64, both backwards
   against the plain backward in float64, and the fast backward must not
   equal the full-precision one; all three also by CUDA-graph replay
   there, at m = 256 and with the nine emulators' 36 GPs in one call),
   the MVN elimination on the path's own covariances at every flagship
   block size, n = 170, 73, 12, 28, 21 and 14, at b = 1024 and at a
   half-ensemble of 512 (the shared-memory route: its warp kernel to
   n = 32, its block kernel past it), stitched (512, 544) and 16 stitched
   matrices grown to n = 767 (the wide route, "panel", with its cluster
   size, panel width and the clusters the card places), one non-PD
   matrix planted in each batch (the MVN
   kernel timed by replaying a CUDA graph of its launches, so that the
   host's enqueue stays out of the measured time); and the fused Woodbury
   epilogue (``woodbury_phase``) at the HMC cells' ranks (9 x 4, and
   24, 23, 11, 88, 13, 19, 24, 48, 88) and 4096 walkers, its value and
   gradient held to 1e-4 normwise of the library route in float64, timed
   against its bound, its plain closed form and the library route;
4. drives seven paths, each with every launch count set to 0 just before
   it and read just after it (a path that never launched one of its
   kernels fails the run; a, d, f and g must launch the fused Woodbury
   forward and backward, h its forward; b, c and h must launch the forward, f and g the
   forward and the fast backward):
   a. ``likelihood_mode="auto"``: the f32 log-posterior on 1024 walkers,
      held within 0.5 log-units (and, for this route, 0.02) of the f64
      numpy oracle at 64 points, then ``Chain.run_MCMC_HMC`` with 1024
      walkers, and again with 256 walkers (``grad_precision="default"``);
   b. ``"generic"``: the log-posterior against the same gate and against
      the ``"auto"`` value, then ``Chain.run_mcmc`` (stretch move, 1024
      walkers, 32 burn-in + 64 production steps);
   c. ``"stitched"``: the log-posterior against the gate and the generic
      value, then a short ``run_mcmc`` (8 + 8 steps), through the MVN
      kernel's wide route;
   d. HMC with ``grad_precision="high"`` (256 walkers, the seed and steps
      of the 256-walker run of a); the default's mean acceptance may not
      fall more than 0.10 below it;
   and three more paths on the same chain, back at
   ``grad_precision="default"`` and ``"auto"`` mode (the three samplers
   cut in depth only, the widths the flagship's):
   f. ``hmc-auto-L+resume``: ``run_hmc`` on ``chain.posterior_with_state()``
      at 256 walkers with ``n_leapfrog="auto"``, ``l_max=8``,
      ``probe_steps=16`` (the defaults are 16 and 64) and 8 warmup steps
      per phase, then ``Chain.run_MCMC_HMC(nsteps=8, warm_start=res)`` (no
      chain file: it starts from the final state) and ``run_MCMC_HMC(
      nsteps=8, resume=True, warm_start=res2)``; the chain file must grow
      from 8 to 16 steps and neither continuation may warm up; the probe's
      gradients per second are logged;
   g. ``ptlmc``: ``Chain.run_MCMC_PTLMC`` with 16 cold and 50 tempered
      chains, maxtemp 100 and 1000 start points, with gradients (32 tuning
      + 16 production steps) and without (16 + 8); the chains must be
      finite, inside the box and of the contract's shape, and no chain's
      log posterior may fall in the pre-optimization by more than
      ``PREOPT_TOL``; the pre-optimization's counts, the milliseconds per
      step and the swap acceptance are logged;
   h. ``smc``: ``run_smc`` with what ``Chain.run_pocoMC`` passes (the
      chain's finite log-likelihood, its state and its box) at 1024 prior,
      256 active, 512 effective particles, ``n_total`` 1024, 1024 evidence
      draws and 6 iterations; the samples must be finite and inside the
      box, the weights sum to 1 and ``logz`` be finite; each iteration's
      beta, MCMC steps, flow-fit steps and its split between flow fit, MCMC
      and host are logged; then a known-evidence problem on the card (a
      normalized 17-d correlated Gaussian likelihood well inside the unit
      box, ``KE_KNOBS``, run to ``n_total``): the importance-sampling
      estimate must land within ``KE_SIGMAS`` of its (khat-calibrated)
      errors plus ``KE_SLACK`` of the log evidence; the selected ``logz``
      and the persistent-sampling estimate are logged against it;
   then trains an emulator with ``parameterTrafoPCA=True`` on the card (a
   synthetic 20-parameter design in the flagship's layout, 500 events),
   holds its predict, predict_pc_raw and predict_pc_raw_fastgrad on 64
   points against its save loaded on the CPU in float64, and draws
   ``sample_y`` on the card; and a tenth path on the same chain,
   j. ``sharded``: the walker mesh (``parallel/mesh.py``), ``make_mesh``
      over up to 4 cards where the machine has two or more, else 4 logical
      shards of cuda:0 (printed); ``devices=`` one past the card count must
      raise; then each step sharded and unsharded at the same seed, the
      counts reset before and read after each, and the forward, the fast
      backward and the shared-memory MVN must launch on every device of
      the mesh (counted per device): (a) the auto value and gradient at
      1024 walkers (``SH_VALUE_RTOL``, ``SH_GRAD_TOL``); (b) the generic
      posterior at 512; (c) ``run_MCMC_HMC(mesh=)``, 1024 walkers,
      windowed with ``persist=0.7``, 4 warmup steps per phase and 8
      steps; (d) ``run_mcmc(mesh=)`` in generic mode from a resumed chain,
      4 steps; (e) ``run_MCMC_PTLMC`` with gradients, 66 chains over 2
      shards, 8 steps (also held as path g holds it); for c, d and e the
      walkers bit-equal to, apart from and apart by more than
      ``SH_RUN_ATOL`` from the unsharded run's are counted and printed,
      and none (c, e) or at most ``SH_MAX_APART_GENERIC`` (d) may be that
      far apart; (f) ``run_pocoMC`` at 1024 / 256 / 512 particles, 2
      iterations (``logz`` within 3 combined errors + 0.5 of the unsharded
      run's, the JAX test's rule); each step's sharded and unsharded wall
      time is printed;
5. frees the flagship chain and builds a second, synthetic one of twice its
   observables: the flagship's blocks twice (1088 observables, 18
   emulators x 4 PCs = 72 RBF GPs on 1000 design points, d = 17), standing
   in for two collision systems calibrated at once; holds the wide MVN
   route against its plain version on this chain's own stitched
   covariances at (512, 1088) (the plain float32 column loop on the first
   16 matrices, the float64 one on all 512) and at (2, 2048) (grown past
   the old cap), then drives a fifth path between a reset and a reading
   of the counts (this chain stays at the ``gp_maxiter=0`` initialization,
   to keep the run's time):
   e. ``"stitched-wide+ensemble"``: the stitched log-posterior on 1024
      walkers against the gate, then ``run_mcmc`` (1024 walkers, 4 + 4
      steps); it must launch the wide route at (512, 1088);
6. frees that chain and drives a ninth path, i. ``analysis``, the
   analysis toolkit as one workflow at the flagship's widths (d = 17,
   n = 1000, the nine observable blocks), between a reset and a reading
   of the counts; it must launch the forward and the fast backward:
   design: ``generate_lhs(1000, 17, seed=0)`` (MaxPro, 20000 annealing
   steps on the card), which must be Latin in every column and beat the
   random LHS it started from in the exact minimum pairwise distance and
   the exact MaxPro criterion (float64, host); training: nine
   ``EmulatorBAND(method="PCSK", kernel_kind="RBF", gp_maxiter=30)`` heads
   in float32 on the synthetic smooth model at the design (1% stat
   errors), fitted jointly on the card and saved, one 170-observable head's
   ``predict`` at 256 points held against its save loaded on the CPU in
   float64 (``held_to_cpu``: at most ``PCA_VS_CPU32`` times the CPU float32
   load's error); validation: ``validate_multiple_emulators`` on fresh
   copies of the two 170-observable heads, the last 100 points held out,
   E and <log H> finite, the held-out predictions held against the
   retrained heads' saves on the CPU; sampling: a ``Chain`` over the nine
   heads (``"auto"``, Woodbury) on pseudo-data at a truth point (5%
   noise), the float32 posterior within ``AUTO_GATE`` of the float64
   oracle at 64 points, then ``run_MCMC_HMC`` (256 walkers, 8 + 8 warmup,
   16 steps); closure: percentiles, Delta_d (logged) and
   ``posterior_predictive`` (64 draws) held against the CPU float64
   copies; sensitivity: ``sensitivity_matrix`` (forward-mode autodiff) of
   the two 170-observable heads at the truth against the CPU float64 copy
   and against central differences (h = 0.01 theta) within 0.05;
   clusters: the HMC chain's log-likelihoods, then
   ``generate_posterior_clusters`` (top 1000, 3 clusters) on the card
   against the CPU float64 run from the same k-means++ starts, centers and
   inertia within 1e-4 relative.  After the counts are read: the forward
   and the fast backward on every BAND head's fused state (b = 11 to 70
   GPs, the PCSK noise in linv and alpha) at the HMC batch's 256 points,
   against their plain versions and float64 at the kernel tolerances
   above, and the posterior's gradient through them at 64 points against
   a CPU float64 chain over the heads' copies (``AN_GRAD_TOL``);
7. prints the kernel table as one JSON line (launches summed over the
   ten paths; path i's per-head errors under ``band_heads``), the card's
   name and power limit, and as its last line
   ``{"ok": true, "device": {...}}``.

Any failed phase raises, so the script exits non-zero without the last
line.  Without CUDA, or outside the repository, it exits non-zero at once.
"""

from __future__ import annotations

import gc
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# flagship shape (the JAX package's bench.py)
BLOCKS = (28, 28, 12, 170, 14, 21, 28, 73, 170)
NDIM = 17
NEV = 1000
NPC = 4
NWALKERS = 1024
HMC_BURN = 16          # warmup steps per phase
HMC_STEPS = 32
ENS_BURN = 32          # generic-mode ensemble run
ENS_STEPS = 64
STITCHED_STEPS = 8     # stitched-mode ensemble run: 8 burn-in + 8 steps
WIDE_BLOCKS = BLOCKS + BLOCKS  # two collision systems of the flagship's size: 1088 observables
WIDE_STEPS = 4         # stitched-wide ensemble run: 4 burn-in + 4 steps
WIDE_PLAIN = 16        # matrices of the (512, 1088) batch held against the float32 plain loop
GROWN_N = 767          # 16 stitched matrices grown to this n: the wide route at small b
HIGH_WALKERS = 256     # HMC with grad_precision="high"
HIGH_BURN = 8
HIGH_STEPS = 16
N_ORACLE = 64
SMEM_SIZES = (170, 73, 12, 28, 21, 14)  # the shared-memory route's cases: every flagship block size
FIT_MAXITER = 30       # the JAX bench's joint fit (bench.py:247)
ALPHA = 0.1            # GPConfig.alpha, the sklearn head's
SCIPY_EMULATORS = (0, 3, 8)
# the JAX package's margin for its fit against sklearn's (tests/test_gp.py:94)
SCIPY_MARGIN = 0.2
PCA_NEV = 500          # the parameter-PCA emulator's training events
# float32 gp_nll against float64 at the fitted hyperparameters, per GP: the
# value's error over max(|nll|, n) and the gradient's largest error over n
# (the nll and each gradient component are sums of n terms).  Measured on
# the flagship fit (H100): 1.7e-7 and 1.9e-7, about 3 float32 epsilons
# (6e-8), as the rounding of a well-conditioned float32 Cholesky leaves
# them (K carries at least alpha + noise = 0.11 on its diagonal); 2e-6 is
# ten times that, while a product that dropped to TF32 (2^-11 per operand)
# or a factor of the wrong lane shows up as 1e-4 or worse.
TOL_NLL32 = 2e-6
TOL_NLL32_GRAD = 2e-6
# The JAX package's float32 fit of the SCIPY_EMULATORS' GP 0 (float64 LML at
# its fitted hyperparameters; tools/fit_float32_gap.py, CPU): the port's
# float32 fit on the card must land there.  The two run different rounding
# (cuSOLVER here, XLA there), so a lane may stop an iteration or two apart;
# near its stop an iteration gains about the ftol threshold, 2.4e-6 |f| =
# 2.6e-3, so 0.05 is some twenty such iterations.  Measured: 2e-4 apart.
JAX_F32_LML = (-971.9086, -1080.7135, -1032.5174)
TOL_F32_REF = 0.05
# the parameter-PCA emulator on the card (float32) against its float64 load
# on the CPU, normwise, at most this many times the error of its float32
# load on the CPU (the same factors through the plain float32 path): a
# smooth emulator's K is ill-conditioned enough that float32 itself sits
# near 1e-3 of float64 there, so the yardstick is float32 on the same
# data, as for the kernels (TOL_VALUES); a fault in the transform or in a
# kernel shows up as O(1).
PCA_VS_CPU32 = 10.0

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, TF32
# on the tensor cores (dense), HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

# kernel-vs-plain tolerances, normwise (max |kernel - plain| / max |plain|):
# both sides are float32 and differ only in summation order over the
# n = 1000 contraction (and over the GP batch); the plain float32 path
# itself sits at about 1e-5 of a float64 evaluation at this shape (the
# float64 check below prints it), so 5e-4 leaves room for the other order
# while any tiling or masking fault shows up as O(1e-2) or worse.
TOL_VALUES = 5e-4
# the forward against the plain forward in FLOAT64 on the same inputs,
# mean and qf normwise: the 3xTF32 product keeps FP32-class accuracy (the
# dropped lo*lo term is 2^-22 relative), so the kernel sits where the
# float32 plain path does; ONE TF32 pass leaves 2^-11 per operand, which
# the alpha-weighted mean turns into errors well above 1e-4, so a forward
# that dropped to one pass cannot pass (tests/test_torch_fused_predict.py::
# test_3xtf32_forward_arithmetic_on_real_factors).
TOL_FWD64 = 1e-4
# the fast backward against the plain backward in FLOAT64, normwise: its
# G^T v product is one TF32 pass (rna rounding, 2^-11 relative per
# operand, FP32 sums), the rest FP32.  That leaves O(1e-4); 2e-3 is ten
# times looser than that and ten times tighter than the JAX package's own
# fast-backward contract (atol 2e-2 max(max|g|, 1),
# tests/test_pallas_predict.py:170-193), while a tiling or masking fault
# shows up as O(1e-2) or worse.
TOL_GRAD = 2e-3
# the full-precision backward against the plain backward in FLOAT64 on the
# same inputs, normwise: FP32-class (3xTF32 with FP32 promotion), so what
# is left is the rounding of two chained FP32 sums over n = 1000.  Worst
# case n * 2^-24 = 6e-5 per sum; the expected sqrt(n) growth is ~4e-6 (the
# float32 plain path's own distance from float64 at this shape).  5e-5 is
# ten times the expected error and below what one TF32 pass leaves (1.4e-4
# for the fast backward here), so a backward that dropped below FP32-class
# cannot pass.
TOL_GRAD_HIGH = 5e-5
# the MVN elimination against its plain version, both float32 and the same
# recurrence in another operation order (the kernel scales the row, the
# plain version the column, and the blocked routes sum 16 or 32 pivots at a
# time):
# max |kernel - plain| / max |plain| over the batch.  2e-4 is the rtol the
# JAX package holds its own kernel to (tests/test_pallas.py); the path's
# covariances are worse conditioned than that test's, and the lp sums
# O(n) terms, which is where the error comes from.
TOL_MVN = 2e-4
# the auto (Woodbury) route's f32 posterior against the f64 oracle: it sat
# at 0.0068 log-units with the all-FP32 predict kernels; 0.02 is three
# times that, well inside the package gate of 0.5, so a forward that lost
# its FP32-class accuracy fails here first.
AUTO_GATE = 0.02
# the fast backward's gradient noise may cost HMC some acceptance, not
# much: the default's mean acceptance against the full-precision run at the
# same walkers, seed and steps
MAX_ACCEPT_DROP = 0.10
# path f, HMC with n_leapfrog="auto" on the flagship: the probe's depth is
# cut (l_max 8 and 16 probe steps, against 16 and 64: 128 probe gradients
# against 1024), the walkers and widths are the flagship's
AUTOL_WALKERS = 256
AUTOL_LMAX = 8
AUTOL_PROBE = 16
AUTOL_BURN = 8         # warmup steps per phase
AUTOL_STEPS = 8        # production steps of each of the three runs
# path g, PTLMC with the JAX package's Chain defaults (16 cold chains, 50
# tempered, maxtemp 100, 1000 start points), cut in depth only
PT_WALKERS = 16
PT_TEMPS = 50
PT_MAXTEMP = 100.0
PT_STARTS = 1000
PT_STEPS = 16          # with gradients: 32 tuning + 16 production steps
PT_STEPS_NOGRAD = 8
# the pre-optimization only accepts steps that raise the log posterior, so
# each chain's optimum is at least its start in exact arithmetic; the two
# are float32 evaluations of the posterior in different batches, each
# within AUTO_GATE of float64 (path a), so they may disagree by twice that
PREOPT_TOL = 2 * AUTO_GATE
# path h, SMC as Chain.run_pocoMC calls it on the flagship, cut in depth
# (6 iterations, and particle counts below run_pocoMC's defaults of 2000 /
# 250 / 1000 / 5000 / 5000)
SMC_FLAGSHIP = dict(n_prior=1024, n_active=256, n_effective=512, n_total=1024,
                    n_evidence=1024, max_iterations=6)
# the known-evidence problem on the card (utils/synthetic.py::
# gaussian_evidence_problem): a normalized 17-d correlated Gaussian
# likelihood (standard deviations 0.05-0.1, |correlations| <= 0.33, means
# 0.4-0.6: at least 4.3 standard deviations inside the unit box), so
# log Z = log(mass inside) = -1.2e-5 under the uniform prior; the run
# goes to n_total
KE_NDIM = 17
# Depth cut: the cold flow fit at 150 steps and the warm ones at 75 (the
# defaults 300 and 100), since each AdamW step costs about 30 ms of host
# dispatch on the card (H100, PR 8) and the run takes 17 to 18 iterations
KE_KNOBS = dict(n_prior=2048, n_active=512, n_effective=1024, n_total=2048,
                n_evidence=4096, flow_fit_steps=150)
# |logz_is - truth| may be 3 errors (khat-inflated as the selection
# inflates them) plus 0.05 for the float32 sums
KE_SIGMAS = 3.0
KE_SLACK = 0.05
# path i, "analysis": the toolkit as one workflow at the flagship's widths
# (d = 17, n = 1000, the nine observable blocks) on BAND PCSK heads with
# the RBF kernel, which take the fused predict kernels
AN_SEED = 0
AN_PREDICT = 256       # points of the card-against-CPU predict check
AN_HOLDOUT = 100       # validation holds out the last 100 design points
AN_WALKERS = 256
AN_BURN = 8            # HMC warmup steps per phase
AN_STEPS = 16
AN_DRAWS = 64          # posterior-predictive draws
AN_EXP_NOISE = 0.05    # the pseudo-data: the model at the truth plus 5% noise
AN_FD_STEP = 0.01
# jacfwd against central differences (h = 0.01 theta) on the card: the
# JAX package's test holds the two to this (tests/test_toolkit.py)
AN_FD_ATOL = 0.05
AN_TOP = 1000
AN_CLUSTERS = 3
# the gradient of path i's posterior (nine BAND heads, 11 to 70 PCs) through
# the fused kernels against the CPU float64 chain, normwise: the fast
# backward's contract (TOL_GRAD)
AN_GRAD_TOL = TOL_GRAD
# k-means on the card (float32) against the CPU float64 run from the same
# k-means++ starts: centers and inertia, relative
AN_CLUSTER_RTOL = 1e-4
# path j, "sharded": the walker mesh (parallel/mesh.py) on the fitted
# flagship chain, at its widths, cut in depth only.  With two or more cards
# make_mesh over up to SH_SHARDS of them, else SH_SHARDS logical shards of
# cuda:0 (a check of the sharded path, not a speed-up)
SH_SHARDS = 4
SH_WALKERS = 1024      # (a) value and gradient, (c) HMC, (d) run_mcmc
SH_GENERIC = 512       # (b): 128 walkers a shard, the shared-memory MVN route
SH_REPS = 3            # (a), (b): calls of each side, in turns
SH_HMC_BURN = 4        # (c): warmup steps per phase (on 256 walkers, "auto")
SH_HMC_STEPS = 8
SH_ENS_STEPS = 4       # (d): from a resumed chain
# (e): PTLMC with gradients, 16 cold + 50 tempered chains (66, over 2 shards:
# 4 do not divide 66), 16 tuning + 8 production steps, 1000 start points
SH_PT_SHARDS = 2
SH_PT = dict(nsteps=8, nwalkers=16, ntemps=50, maxtemp=100.0, nstartparameters=1000,
             use_gradients=True)
# (f): run_pocoMC at 1024 prior / 256 active / 512 effective particles, 2
# iterations, the flow fit cut to 50 cold and 25 warm AdamW steps (each
# costs 20-30 ms of host dispatch on an H100)
SH_SMC = dict(n_prior=1024, n_active=256, n_effective=512, n_total=1024, n_evidence=1024,
              max_iterations=2, flow_fit_steps=50, flow_fit_steps_warm=25)
# (a), (b): sharded against unsharded, values as max |lp_s - lp_u| /
# max(|lp_u|, 1) and gradients normwise.  Both sides run the same kernels
# with the same per-walker arithmetic; what may differ is the library's
# choice of algorithm for another batch size (cuBLAS products, the batched
# Cholesky of the Woodbury block), which reorders float32 sums: O(1e-7)
# relative.  2e-5 is a hundred times that and 25 times inside the JAX dry
# run's 5e-4 (__graft_entry__.py:119-133); 1e-4 for the gradient is 20
# times inside the fast backward's own TOL_GRAD.  A shard gathered out of
# order or evaluated on the wrong replica is off by O(1).
SH_VALUE_RTOL = 2e-5
SH_GRAD_TOL = 1e-4
# (c), (d), (e): per walker, the largest |x_sharded - x_unsharded| over its
# chain (unit box).  Only the posterior evaluations are sharded: every draw,
# the u -> x transform of HMC and the chain rule back, the adaptation and the
# swaps run on cuda:0 over the whole batch in both runs.  (c) and (e) use the
# auto posterior, whose values and gradients (a) finds bit-equal sharded and
# unsharded, so no walker may be apart by more than SH_RUN_ATOL.  (d) uses
# the generic one, whose values (b) finds up to ~4e-7 relative apart
# (~3e-4 log-units at the flagship's |lp| ~ 750): a stretch-move decision
# turns where its log-ratio lies that close to its uniform's log, about 3e-4
# of the 4096 decisions, and the positions are drawn from positions alone,
# so a walker is apart only after such a turn, its own or a partner's.  At
# most SH_MAX_APART_GENERIC of the walkers may be: a fault in one shard moves
# all its walkers, a quarter of them.
SH_RUN_ATOL = 1e-3
SH_MAX_APART_GENERIC = 0.01


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 9) -> float:
    """Mean device time of ``fn`` in ms (CUDA events, after one warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20, replays: int = 3) -> float:
    """Device time of one call of ``fn`` in ms: ``reps`` calls captured in
    one CUDA graph, replayed once to warm up, then ``replays`` times between
    two CUDA events.  The host's enqueue of each launch stays outside the
    timed window, which it does not with :func:`cuda_ms` when a kernel is
    shorter than its launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def normwise(a, b) -> tuple[float, float]:
    """(max abs error, max abs error / max |b|) of a against b."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-30)


def fwd_work(b, n, m, d, save_v):
    """(TF32 tensor-core flops, FP32 flops, bytes) the forward needs on these
    inputs: [G; alpha] against k* (lower triangle and the alpha row) in
    three TF32 passes; the qf reduction and the k* build in FP32; each
    input read once, each output written once (float32)."""
    tc_flops = 3 * b * m * (n * (n + 1) + 2 * n)
    fp32_flops = b * (2 * n * m + n * m * (3 * d + 2))
    nbytes = 4 * (b * n * n + b * n * d + m * d + b * d + b * n + b
                  + 2 * b * m + (b * n * m if save_v else 0))
    return tc_flops, fp32_flops, nbytes


def bwd_work(b, n, m, d, passes):
    """(TF32 flops, FP32 flops, bytes) of a backward: G^T against v (lower
    triangle) in ``passes`` TF32 passes (0: FP32); ct_v's scalings and the
    alpha term, the k* recompute and ct_z, the query cotangent in FP32."""
    prod = b * n * (n + 1) * m
    fp32_flops = b * (2 * n * m + n * m * (3 * d + 4) + 3 * n * m * d)
    nbytes = 4 * (b * n * n + b * n * d + m * d + b * d + b * n + b
                  + b * n * m + 2 * b * m + b * m * d)
    if passes == 0:
        return 0, prod + fp32_flops, nbytes
    return passes * prod, fp32_flops, nbytes


def mvn_work(b, n, n_bad=0):
    """(flops, bytes) of the MVN elimination on these inputs: per healthy
    matrix and pivot k, one FMA for each entry of the trailing lower
    triangle with the y row ((n - k)(n - k + 1) / 2 of them) plus the
    scaling of column k, and a log: about n^3 / 3 flops.  A matrix that is
    not positive definite at its first pivot costs nothing.  cov is
    symmetric, so its lower triangle read once is all the function needs,
    with y; lp is written once (float32)."""
    per = sum((n - k) * (n - k + 1) + (n - k) + 2 for k in range(n))
    return (b - n_bad) * per, 4 * (b * (n * (n + 1) // 2 + n) + b)


def wide_work(b, n, p, n_bad=0):
    """(FP32 flops, TF32 tensor-core flops, bytes) of the same work as
    :func:`mvn_work` as the wide route does it: each p-column panel's
    trailing update (the trailing lower triangle with the y row, m (m + 1)
    entries' worth of flops per pivot of the panel, m = n + 1 - c1) in
    three TF32 passes, the rest (the panels' own columns, the logarithms)
    in FP32."""
    flops, nbytes = mvn_work(b, n, n_bad)
    trailing = 0
    for c0 in range(0, n, p):
        c1 = min(c0 + p, n)
        m = n + 1 - c1
        trailing += (c1 - c0) * m * (m + 1)
    trailing *= b - n_bad
    return flops - trailing, 3 * trailing, nbytes


def bound_ms(flops, nbytes, tc_flops=0):
    """The least time for the work: FP32 flops at the FP32 peak plus TF32
    tensor-core flops at the TF32 peak, or the bytes at the memory rate,
    whichever is larger."""
    t_ops = flops / PEAK_FP32_FLOPS + tc_flops / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tf32_ms(fn):
    """cuda_ms of ``fn`` with TF32 matmuls allowed (a yardstick only; the
    port never allows them), the setting restored afterwards."""
    import torch

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return cuda_ms(fn)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def hold_fused(fs, xq, ct_mean, ct_qf, label, high):
    """The forward and the fast backward (and, with ``high``, the
    full-precision backward) on the card against their plain versions on
    the same inputs: the forward against the float32 plain forward
    (TOL_VALUES) and the plain forward in float64 (TOL_FWD64), each backward
    against the plain backward in float64 (TOL_GRAD, TOL_GRAD_HIGH).  Exits
    on a miss.  Returns the forward's max abs error (mean and qf), the
    normwise errors ``{"fwd": .., "fwd64": .., "bwd": ..}``, and the
    backwards' max abs errors (the high one None without ``high``).  The
    kernel's v is the (b, n, m) view of the v^T it saves, so it compares
    with the plain v element by element as it is."""
    import torch
    from gpbayestools_hic_tpu_torch.ops import fused_predict as fp

    b, n, d = fs.xs.shape
    at = f"{label}(b={b}, n={n}, d={d}, m={xq.shape[0]})"
    fs64 = fp.state_as(fs, torch.float64)
    mean_k, qf_k, v_k = fp.fused_fwd(fs, xq, save_v=True)
    mean_p, qf_p, v_p = fp.fused_fwd_plain(fs, xq, save_v=True)
    torch.cuda.synchronize()
    e_mean, r_mean = normwise(mean_k, mean_p)
    e_qf, r_qf = normwise(qf_k, qf_p)
    e_v, r_v = normwise(v_k, v_p)
    log(f"kernel fused_predict_fwd vs plain {at}: "
        f"mean max abs {e_mean:.3e} (normwise {r_mean:.3e}), qf max abs "
        f"{e_qf:.3e} (normwise {r_qf:.3e}), v normwise {r_v:.3e}; tolerance "
        f"{TOL_VALUES:g} normwise -- float32 on both sides, different "
        f"summation order over n = {n}")
    if not max(r_mean, r_qf, r_v) <= TOL_VALUES:
        raise SystemExit(f"fused_predict_fwd disagrees with its plain version {at}")
    mean64, qf64, _ = fp.fused_fwd_plain(fs64, xq.double())
    e_mean64, r_mean64 = normwise(mean_k, mean64)
    e_qf64, r_qf64 = normwise(qf_k, qf64)
    _, r_mean_p64 = normwise(mean_p, mean64)
    _, r_qf_p64 = normwise(qf_p, qf64)
    log(f"kernel fused_predict_fwd vs the plain forward in float64 {at}: mean max abs "
        f"{e_mean64:.3e} (normwise {r_mean64:.3e}), qf max abs {e_qf64:.3e} "
        f"(normwise {r_qf64:.3e}); the float32 plain path sits at {r_mean_p64:.3e} / "
        f"{r_qf_p64:.3e}; tolerance {TOL_FWD64:g} normwise -- 3xTF32, FP32 sums")
    if not max(r_mean64, r_qf64) <= TOL_FWD64:
        raise SystemExit(f"fused_predict_fwd is not FP32-class against the float64 forward {at}")

    # the backward kernels against the plain backward in float64 on the same inputs
    g_kern = fp.fused_bwd(fs, xq, v_k, ct_mean, ct_qf).sum(0)
    torch.cuda.synchronize()
    g_plain = fp.fused_bwd_plain(fs, xq, v_k, ct_mean, ct_qf).sum(0)
    g64 = fp.fused_bwd_plain(fs64, xq.double(), v_k.double(), ct_mean.double(),
                             ct_qf.double()).sum(0)
    e_g, r_g = normwise(g_kern, g64)
    _, r_plain64 = normwise(g_plain, g64)
    log(f"kernel fused_predict_bwd vs the plain backward in float64 {at}: max abs "
        f"{e_g:.3e} (normwise {r_g:.3e}; the float32 plain backward sits at "
        f"{r_plain64:.3e}); tolerance {TOL_GRAD:g} normwise -- one TF32 pass on "
        f"G^T v over n = {n}, the rest FP32")
    if not r_g <= TOL_GRAD:
        raise SystemExit(f"fused_predict_bwd disagrees with the float64 plain backward {at}")
    e_h = None
    if high:
        g_high = fp.fused_bwd(fs, xq, v_k, ct_mean, ct_qf, "high").sum(0)
        if torch.equal(g_kern, g_high):
            raise SystemExit("fused_predict_bwd equals fused_predict_bwd_high bit for bit: "
                             "the grad_precision knob is dead")
        e_h, r_h = normwise(g_high, g64)
        log(f"kernel fused_predict_bwd_high vs the plain backward in float64 {at}: max abs "
            f"{e_h:.3e} (normwise {r_h:.3e}); tolerance {TOL_GRAD_HIGH:g} normwise -- "
            f"3xTF32 G^T v, FP32 promotion per ring stage (32 contraction steps) over n = {n}")
        if not r_h <= TOL_GRAD_HIGH:
            raise SystemExit(f"fused_predict_bwd_high disagrees with the float64 plain "
                             f"backward {at}")
    errs = {"fwd": max(r_mean, r_qf, r_v), "fwd64": max(r_mean64, r_qf64), "bwd": r_g}
    return max(e_mean, e_qf), errs, e_g, e_h


def sass_evidence() -> str:
    """Hopper instructions in the built libraries' SASS, per kernel
    (``cuobjdump -sass``, where the toolkit has it): the predict kernels'
    products (the forward's and both backwards') should hold HGMMA (wgmma)
    and UTMALDG (TMA loads) and no HMMA (mma.sync); the shared-memory MVN
    route's two kernels hold none of them (FP32 FMA); the wide MVN route's
    trailing update runs on the tensor cores (HMMA).  Evidence printed; one
    gate: ``mvn_wide_kernel``, the stitched likelihood's MVN, must hold
    tensor-core instructions (HMMA or HGMMA), and the run fails where they
    cannot be counted (no ``cuobjdump`` beside nvcc or on the PATH)."""
    from gpbayestools_hic_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        raise SystemExit("SASS: cuobjdump not found beside nvcc or on the PATH; the wide MVN "
                         "kernel's tensor-core instructions cannot be counted")
    counts = {}
    for lib, kernels in (
            ("fused_predict", r"(kstar_kernel|fwd_wgmma_kernel|bwd_wgmma_kernel|bwd_high_kernel|"
                              r"rowsum_kernel)(I(?:L[ib]\d+E)+E)?"),
            ("fused_mvn", r"(mvn_warp_kernel|mvn_smem_kernel|mvn_wide_kernel)"
                          r"(I(?:L[ib]\d+E)+E)?")):
        sass = subprocess.run([tool, "-sass", str(_build.lib_path(lib))],
                              capture_output=True, text=True).stdout
        for chunk in sass.split("Function : ")[1:]:
            name = re.search(kernels, chunk.split("\n", 1)[0])
            if name is None:
                continue
            counts[name.group(0)] = {op: len(re.findall(rf"\b{op}[.\s]", chunk))
                                     for op in ("HGMMA", "UTMALDG", "HMMA")}
    wide = [c for name, c in counts.items() if name.startswith("mvn_wide_kernel")]
    if not wide or any(c["HMMA"] + c["HGMMA"] == 0 for c in wide):
        raise SystemExit(f"mvn_wide_kernel's SASS holds no tensor-core instruction: {counts}")
    return f"SASS ({tool} -sass), instructions per kernel: {counts}"


def kernel_phase(chain, device):
    """Each kernel against its plain version at one emulator's shape, and
    timings rotated over the 9 emulators' states (144 MB of G, beyond the
    50 MB L2, as the main path sees them)."""
    import torch
    from gpbayestools_hic_tpu_torch.ops import fused_predict as fp

    rng = np.random.default_rng(1)
    states = [e._fused for e in chain.emuList]
    fs = states[0]
    b, n, d = fs.xs.shape
    m = NWALKERS
    xq = torch.tensor(rng.uniform(0.0, 1.0, (m, d)), dtype=torch.float32, device=device)
    ct_mean = torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32, device=device)
    ct_qf = torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32, device=device)

    e_fwd, _, e_g, e_h = hold_fused(fs, xq, ct_mean, ct_qf, "", high=True)
    # again at path d's walker count: there the kernels take one consumer
    # warpgroup (64 walkers a block), another instance of each backward
    m_d = HIGH_WALKERS
    _, _, _, e_h_d = hold_fused(fs, xq[:m_d].contiguous(), ct_mean[:, :m_d].contiguous(),
                                ct_qf[:, :m_d].contiguous(), f"m={m_d} ", high=True)
    e_h = max(e_h, e_h_d)

    # timings, rotating over the emulators' states, after half a second of
    # the forward (the card idles through the CPU-bound checks before this
    # phase, and its clocks must be up before the first timed call)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        for s in states:
            fp.fused_fwd(s, xq, save_v=True)
        torch.cuda.synchronize()
    vs = [fp.fused_fwd(s, xq, save_v=True)[2] for s in states]
    kst = [fp._kstar_plain(s, xq)[2] for s in states]
    cts = [2.0 * v * ct_qf[:, None, :] for v in vs]

    def rot(f):
        def run():
            for i, s in enumerate(states):
                f(i, s)
        return lambda: run()

    per = len(states)
    t_fwd = cuda_ms(rot(lambda i, s: fp.fused_fwd(s, xq, save_v=True))) / per
    t_fwd_plain = cuda_ms(rot(lambda i, s: fp.fused_fwd_plain(s, xq, save_v=True))) / per
    fwd_lib = rot(lambda i, s: torch.bmm(s.G, kst[i]))
    bwd_lib = rot(lambda i, s: torch.bmm(s.G.transpose(1, 2), cts[i]))
    t_fwd_lib, t_fwd_lib32 = cuda_ms(fwd_lib) / per, tf32_ms(fwd_lib) / per
    t_bwd = cuda_ms(rot(lambda i, s: fp.fused_bwd(s, xq, vs[i], ct_mean, ct_qf))) / per
    t_high = cuda_ms(rot(lambda i, s: fp.fused_bwd(s, xq, vs[i], ct_mean, ct_qf, "high"))) / per
    t_bwd_plain = cuda_ms(rot(lambda i, s: fp.fused_bwd_plain(s, xq, vs[i], ct_mean, ct_qf))) / per
    t_bwd_lib, t_bwd_lib32 = cuda_ms(bwd_lib) / per, tf32_ms(bwd_lib) / per
    stats = {}
    for name, t, tp, tl, tl32, (tc, fl, nbytes), err, precision in (
        ("fused_predict_fwd", t_fwd, t_fwd_plain, t_fwd_lib, t_fwd_lib32,
         fwd_work(b, n, m, d, save_v=True), e_fwd,
         "3xTF32 tensor cores for [G; alpha] k*, FP32 k* and qf"),
        ("fused_predict_bwd", t_bwd, t_bwd_plain, t_bwd_lib, t_bwd_lib32,
         bwd_work(b, n, m, d, passes=1), e_g,
         "one TF32 pass (tensor cores) for G^T v, FP32 for the rest"),
        ("fused_predict_bwd_high", t_high, t_bwd_plain, t_bwd_lib, t_bwd_lib32,
         bwd_work(b, n, m, d, passes=3), e_h,
         "3xTF32 tensor cores for G^T v (FP32 promotion per ring stage of 32 "
         "contraction steps), FP32 for the rest"),
    ):
        bd, why = bound_ms(fl, nbytes, tc)
        log(f"timing {name}: kernel {t:.4f} ms ({(tc + fl) / t / 1e9:.1f} TFLOP/s), "
            f"plain {tp:.4f} ms, library yardstick (torch.bmm of the dominant "
            f"product) {tl:.4f} ms in FP32, {tl32:.4f} ms in TF32, bound {bd:.4f} ms "
            f"({why}: {tc / 1e9:.2f} GFLOP TF32 + {fl / 1e9:.2f} GFLOP FP32, "
            f"{nbytes / 1e6:.1f} MB)")
        stats[name] = dict(max_abs_err=err, ms=t, plain_ms=tp, bound_ms=bd, bound_by=why,
                           library_ms=tl, library_tf32_ms=tl32, precision=precision,
                           timing="CUDA events around 9 rotations over the 9 emulators")

    # the forward and both backwards by CUDA-graph replay (the host's
    # enqueue outside the time): at this shape, at a quarter of the walkers
    # (m = 256: HMC's second run and path d, PTLMC, each shard of path j)
    # and with the nine emulators' GPs in one call (b = 36)
    merged = fp.FusedState(*(torch.cat([getattr(s, f) for s in states]).contiguous()
                             for f in fp.TENSOR_FIELDS), kind=states[0].kind)
    ct36 = [torch.tensor(rng.normal(size=(merged.xs.shape[0], m)), dtype=torch.float32,
                         device=device) for _ in range(2)]
    for group, mm, ctm, ctq in (
            (states, m, ct_mean, ct_qf),
            (states, 256, ct_mean[:, :256].contiguous(), ct_qf[:, :256].contiguous()),
            ([merged], m, *ct36)):
        xq_c = xq[:mm].contiguous()
        vs_c = [fp.fused_fwd(s, xq_c, save_v=True)[2] for s in group]
        t_f = graph_ms(lambda: [fp.fused_fwd(s, xq_c, save_v=True) for s in group],
                       reps=2) / len(group)
        t_b = graph_ms(lambda: [fp.fused_bwd(s, xq_c, vs_c[i], ctm, ctq)
                                for i, s in enumerate(group)], reps=2) / len(group)
        t_h = graph_ms(lambda: [fp.fused_bwd(s, xq_c, vs_c[i], ctm, ctq, "high")
                                for i, s in enumerate(group)], reps=2) / len(group)
        # the library yardsticks at this shape: torch.bmm of the dominant
        # product, FP32 and TF32, by graph replay too
        ksts = [fp._kstar_plain(s, xq_c)[2] for s in group]
        cts_c = [2.0 * v * ctq[:, None, :] for v in vs_c]
        lib = {"fwd": graph_lib_ms(lambda: [torch.bmm(s.G, ksts[i])
                                            for i, s in enumerate(group)]),
               "bwd": graph_lib_ms(lambda: [torch.bmm(s.G.transpose(1, 2), cts_c[i])
                                            for i, s in enumerate(group)])}
        del ksts, cts_c
        bb = group[0].xs.shape[0]
        for name, t, (tc, fl, nbytes), (tl, tl32) in (
                ("fused_predict_fwd", t_f, fwd_work(bb, n, mm, d, save_v=True), lib["fwd"]),
                ("fused_predict_bwd", t_b, bwd_work(bb, n, mm, d, passes=1), lib["bwd"]),
                ("fused_predict_bwd_high", t_h, bwd_work(bb, n, mm, d, passes=3), lib["bwd"])):
            bd, why = bound_ms(fl, nbytes, tc)
            tl, tl32 = tl / len(group), tl32 / len(group)
            log(f"timing {name} by CUDA-graph replay at b={bb}, n={n}, d={d}, m={mm}: "
                f"{t:.4f} ms, bound {bd:.4f} ms ({why}), library yardstick {tl:.4f} ms FP32, "
                f"{tl32:.4f} ms TF32")
            stats[name].setdefault("graph_replay", []).append(
                dict(b=bb, n=n, d=d, m=mm, ms=t, bound_ms=bd, bound_by=why, library_ms=tl,
                     library_tf32_ms=tl32))
    return stats


def matern_state(device, b, n, d, seed):
    """A float32 Matern-1.5 fused state of b GPs on n random training points
    in d dimensions, with a PCSK-like per-design noise in its factor (the
    known-hyperparameter path, as the PCSK cell loads its heads)."""
    import torch
    from gpbayestools_hic_tpu_torch.models.gp import GPConfig, finalize_gp_state
    from gpbayestools_hic_tpu_torch.ops import fused_predict as fp
    from gpbayestools_hic_tpu_torch.ops.kernels import KernelConfig

    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    x = torch.tensor(rng.uniform(0, 1, (n, d)), **f32)
    params = {"log_amp": torch.tensor(rng.uniform(-0.5, 0.5, b), **f32),
              "log_ls": torch.tensor(rng.uniform(-0.5, 1.0, (b, d)), **f32),
              "log_noise": torch.full((b,), -4.6, **f32)}
    y = torch.tensor(rng.normal(size=(b, n)), **f32)
    noise = torch.tensor(rng.uniform(0.0, 0.05, (b, n)), **f32)
    st = finalize_gp_state(params, x, y, GPConfig(kernel=KernelConfig("Matern"), alpha=1e-6),
                           noise)
    return fp.build_fused_state(st.params, st.x, st.linv, st.alpha_vec, "Matern")


def matern_phase(device):
    """The Matern-1.5 instances (``fused_predict_*_matern``: the Matern k*
    pre-pass, the shared product kernels, the backwards reading its weight)
    against their plain versions and float64 (hold_fused's tolerances, the
    three-pass backward too), at the kernel table's shape (b 4, n 1000, d 17,
    m 1024) and at the PCSK cell's widest block (b 88, n 1095, d 20, m 4096),
    and timed there by CUDA-graph replay against the RBF instance on the same
    factor, the plain version and the library's product."""
    import torch
    from gpbayestools_hic_tpu_torch.ops import fused_predict as fp

    stats = {}
    for b, n, d, m in ((4, NEV, NDIM, NWALKERS), (88, 1095, 20, 4096)):
        fs = matern_state(device, b, n, d, seed=b)
        rng = np.random.default_rng(7)
        xq = torch.tensor(rng.uniform(0.0, 1.0, (m, d)), dtype=torch.float32, device=device)
        # one query on a training point: r = 0, where Matern's weight is finite
        xq[0] = fs.xs[0, 0] / fs.inv_ls[0]
        ct_mean, ct_qf = (torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32,
                                       device=device) for _ in range(2))
        e_fwd, errs, e_g, e_h = hold_fused(fs, xq, ct_mean, ct_qf, "Matern ", high=True)
        rbf = fs._replace(kind="RBF")
        v_m = fp.fused_fwd(fs, xq, save_v=True)[2]
        v_r = fp.fused_fwd(rbf, xq, save_v=True)[2]
        t = {}
        for fam, st, v in (("matern", fs, v_m), ("rbf", rbf, v_r)):
            t[fam] = (graph_ms(lambda: fp.fused_fwd(st, xq, save_v=True), reps=2),
                      graph_ms(lambda: fp.fused_bwd(st, xq, v, ct_mean, ct_qf), reps=2),
                      graph_ms(lambda: fp.fused_bwd(st, xq, v, ct_mean, ct_qf, "high"), reps=2))
        plain = (cuda_ms(lambda: fp.fused_fwd_plain(fs, xq, save_v=True), reps=2),
                 cuda_ms(lambda: fp.fused_bwd_plain(fs, xq, v_m, ct_mean, ct_qf), reps=2))
        kst = fp._kstar_plain(fs, xq)[2]
        ct = 2.0 * v_m * ct_qf[:, None, :]
        lib = {"fwd": graph_lib_ms(lambda: torch.bmm(fs.G, kst)),
               "bwd": graph_lib_ms(lambda: torch.bmm(fs.G.transpose(1, 2), ct))}
        del kst, ct, v_m, v_r
        for i, (name, tp, (tl, tl32), err) in enumerate((
                ("fused_predict_fwd_matern", plain[0], lib["fwd"], e_fwd),
                ("fused_predict_bwd_matern", plain[1], lib["bwd"], e_g),
                ("fused_predict_bwd_high_matern", plain[1], lib["bwd"], e_h))):
            log(f"timing {name} by CUDA-graph replay at b={b}, n={n}, d={d}, m={m}: "
                f"{t['matern'][i]:.4f} ms, the RBF instance {t['rbf'][i]:.4f} ms, plain "
                f"{tp:.4f} ms, library yardstick {tl:.4f} ms FP32, {tl32:.4f} ms TF32")
            stats.setdefault(name, {"precision": "as the RBF instance", "max_abs_err": err,
                                    "shapes": []})["shapes"].append(
                dict(b=b, n=n, d=d, m=m, ms=t["matern"][i], rbf_ms=t["rbf"][i], plain_ms=tp,
                     library_ms=tl, library_tf32_ms=tl32, max_abs_err=err,
                     normwise=errs if i == 0 else None))
        del fs, rbf
        torch.cuda.empty_cache()
    return stats


WOODBURY = ("fused_woodbury_fwd", "fused_woodbury_bwd")
# the cells' Woodbury ranks: auau-bes's nine blocks of 4 PCs, auau-bes-pcsk's
WOODBURY_SHAPES = {"bes-hmc": (4,) * 9, "pcsk-hmc": (24, 23, 11, 88, 13, 19, 24, 48, 88)}
WOODBURY_WALKERS = 4096


def woodbury_inputs(ks, m, device, seed):
    """Per block: its state (M^-1 SPD, eigenvalues in [0.5, 2]) and gp_mean,
    qf, kdiag laid out as the fused predict leaves them ((k, m) storage seen
    as (m, k)), float32 on the card; v = max(kdiag - qf, 0) in [0, 0.3]."""
    import torch

    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    out = []
    for k in ks:
        q, _ = np.linalg.qr(rng.normal(size=(k, k)))
        m_inv = (q * rng.uniform(0.5, 2.0, k)) @ q.T
        bs = {"p0": torch.tensor(rng.normal(size=k), **f32),
              "m_inv": torch.tensor(0.5 * (m_inv + m_inv.T), **f32),
              "const2": torch.tensor(rng.uniform(10, 50), **f32),
              "logdet_c0_m": torch.tensor(rng.uniform(-20, 20), **f32)}
        kd = rng.uniform(0.5, 1.0, k)
        mean = torch.tensor(rng.normal(size=(k, m)), **f32).t() + bs["p0"]
        qf = torch.tensor((kd[:, None] - rng.uniform(0.0, 0.3, (k, m))), **f32).t()
        out.append((bs, mean.t().contiguous().t(), qf, torch.tensor(kd, **f32)))
    return out


def woodbury_work(ks, m, grad):
    """(FP32 flops, bytes) of the Woodbury epilogue at these ranks: per
    walker-block the Cholesky (k^3 / 3 flops) and the solve (k^2), with a
    gradient L^-1 (k^3 / 3), alpha and diag(B^-1) (2 k^2); gp_mean and qf
    read once, lp written, with a gradient alpha and the diagonal written.
    The backward: alpha, the diagonal, qf, lp and the cotangent read, two
    cotangents written, 6 flops an entry."""
    fwd_flops = sum(k ** 3 / 3 + 2 * k * k + (k ** 3 / 3 + 4 * k * k if grad else 0) for k in ks)
    fwd_bytes = 4 * m * (sum(2 * k for k in ks) + len(ks) + (2 * sum(ks) if grad else 0))
    bwd_bytes = 4 * m * (5 * sum(ks) + 2 * len(ks))
    return fwd_flops * m, fwd_bytes, 6 * m * sum(ks), bwd_bytes


def woodbury_phase(device):
    """The fused Woodbury kernels at the HMC cells' ranks and 4096 walkers:
    the forward with a gradient (and without) and the backward timed by
    CUDA-graph replay, against the bound, the plain closed form and the
    library route as the posterior ran it before the kernels (per block
    ``cholesky_ex`` + ``solve_triangular`` + ``where``, differentiated by
    autograd; CUDA events, the host's enqueue included); the value and the
    gradient against the library route in float64 on the CPU (normwise,
    tolerance 1e-4, the card tests')."""
    import torch
    from gpbayestools_hic_tpu_torch.ops import fused_woodbury as fw
    from gpbayestools_hic_tpu_torch.samplers import chain as chain_mod

    stats = {name: {"precision": "FP32 (IEEE division and square root)", "shapes": []}
             for name in WOODBURY}
    for cell, ks in WOODBURY_SHAPES.items():
        m = WOODBURY_WALKERS
        blocks = woodbury_inputs(ks, m, device, seed=len(ks) + sum(ks))
        states, means, qfs, kds = (list(t) for t in zip(*blocks))
        leaves = [t.detach().requires_grad_(True) for t in means + qfs]

        def fused_vg():
            lp = fw.fused_woodbury(states, leaves[:len(ks)], leaves[len(ks):], kds).sum(1)
            return torch.autograd.grad(lp, leaves, torch.ones_like(lp))

        def library_vg():
            lp = torch.stack([chain_mod._lowrank_library(bs, mn, qf, kd) for bs, mn, qf, kd
                              in zip(states, leaves[:len(ks)], leaves[len(ks):], kds)], 1).sum(1)
            return torch.autograd.grad(lp, leaves, torch.ones_like(lp))

        def plain_vg():
            out = []
            for bs, mn, qf, kd in zip(states, means, qfs, kds):
                lp, alpha, dinv = fw.woodbury_plain(bs, mn, qf, kd)
                out.append(fw.woodbury_grad_plain(torch.ones_like(lp), lp, alpha, dinv, qf, kd))
            return out

        with torch.no_grad():
            t_fwd = graph_ms(lambda: fw._fwd_cuda(states, kds, means, qfs, True), reps=5)
            t_val = graph_ms(lambda: fw._fwd_cuda(states, kds, means, qfs, False), reps=5)
            lp, saved = fw._fwd_cuda(states, kds, means, qfs, True)
            g = torch.ones_like(lp)
            t_bwd = graph_ms(lambda: fw._bwd_cuda(states, kds, qfs, lp, g, saved), reps=5)
        t_lib = cuda_ms(library_vg, reps=3)
        t_plain = cuda_ms(plain_vg, reps=3)
        t_vg = cuda_ms(fused_vg, reps=5)
        grads = fused_vg()
        e_lp, e_g = 0.0, 0.0
        for j, (bs, mn, qf, kd) in enumerate(blocks):
            cpu = dict(dtype=torch.float64, device="cpu")
            bs64 = {k: v.to(**cpu) for k, v in bs.items()}
            mn64, qf64 = (t.detach().to(**cpu).requires_grad_(True) for t in (mn, qf))
            want = chain_mod._lowrank_library(bs64, mn64, qf64, kd.to(**cpu))
            gm, gq = torch.autograd.grad(want, (mn64, qf64), torch.ones_like(want))
            e_lp = max(e_lp, normwise(lp[:, j].cpu(), want.detach())[1])
            e_g = max(e_g, normwise(grads[j].cpu(), gm)[1],
                      normwise(grads[len(ks) + j].cpu(), gq)[1])
        if max(e_lp, e_g) > 1e-4:
            raise SystemExit(f"fused Woodbury at {cell}'s ranks: normwise error {e_lp:.3g} "
                             f"(lp), {e_g:.3g} (gradient) against float64, tolerance 1e-4")
        f_flops, f_bytes, b_flops, b_bytes = woodbury_work(ks, m, True)
        v_flops, v_bytes, _, _ = woodbury_work(ks, m, False)
        bound_f, by_f = bound_ms(f_flops, f_bytes)
        bound_v, by_v = bound_ms(v_flops, v_bytes)
        bound_b, by_b = bound_ms(b_flops, b_bytes)
        log(f"timing fused Woodbury at {cell}'s ranks {list(ks)}, m={m}: forward with the "
            f"gradient's saves {t_fwd:.4f} ms (bound {bound_f:.4f}, {by_f}), value only "
            f"{t_val:.4f} ms (bound {bound_v:.4f}, {by_v}), backward {t_bwd:.4f} ms (bound "
            f"{bound_b:.4f}, {by_b}); value and gradient by events: op {t_vg:.4f} ms, plain "
            f"{t_plain:.4f} ms, library route {t_lib:.4f} ms; error against float64 "
            f"{e_lp:.3g} (lp), {e_g:.3g} (gradient), normwise")
        common = dict(cell=cell, ks=list(ks), m=m, plain_value_and_grad_ms=t_plain,
                      library_value_and_grad_ms=t_lib, op_value_and_grad_ms=t_vg)
        stats["fused_woodbury_fwd"]["shapes"].append(dict(
            common, ms=t_fwd, value_only_ms=t_val, bound_ms=bound_f, bound_by=by_f,
            value_only_bound_ms=bound_v, normwise_lp=e_lp))
        stats["fused_woodbury_bwd"]["shapes"].append(dict(
            common, ms=t_bwd, bound_ms=bound_b, bound_by=by_b, normwise_grad=e_g))
        del blocks, states, means, qfs, kds, leaves, lp, saved, grads
        torch.cuda.empty_cache()
    return stats


def graph_lib_ms(fn):
    """(FP32, TF32) graph_ms of a library call, TF32 matmuls allowed only
    for the second (a yardstick; the port never allows them), the setting
    restored afterwards."""
    import torch

    before = torch.backends.cuda.matmul.allow_tf32
    try:
        out = []
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            out.append(graph_ms(fn, reps=2))
        return tuple(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def mvn_inputs(chain, device, blocks=BLOCKS):
    """``block_inputs(idx, m)``: the residual y (m, n) and covariance
    (m, n, n) that the generic path hands the MVN kernel for emulator block
    ``idx`` (its emulator's predictive covariance plus the experimental
    variances) at the first m of 1024 walkers drawn with seed 3."""
    import torch

    x = torch.tensor(chain.random_pos(NWALKERS, seed=3), dtype=torch.float32, device=device)
    exp = torch.tensor(np.asarray(chain.expdata).flatten(), dtype=torch.float32, device=device)
    exp_var = torch.tensor(np.diagonal(chain.expdata_cov).copy(), dtype=torch.float32,
                           device=device)
    offsets = np.cumsum([0] + list(blocks))

    def block_inputs(idx, m):
        i0, i1 = offsets[idx], offsets[idx + 1]
        with torch.no_grad():
            mu, cov = chain.emuList[idx]._predict_full(x[:m], torch.zeros(m, device=device))
        return (mu - exp[i0:i1]).contiguous(), (cov + torch.diag(exp_var[i0:i1])).contiguous()

    return block_inputs


def stitched_inputs(chain, device, block_inputs, blocks=BLOCKS):
    """``stitched(m)``: the residual (m, nobs) and the block-diagonal
    stitched covariance (m, nobs, nobs) the stitched path hands the MVN
    kernel, from the same walkers as ``block_inputs``."""
    import torch

    offsets = np.cumsum([0] + list(blocks))

    def stitched(m):
        ys, cov = [], torch.zeros((m, chain.nobs, chain.nobs), dtype=torch.float32,
                                  device=device)
        for idx in range(len(blocks)):
            i0, i1 = offsets[idx], offsets[idx + 1]
            y_i, c_i = block_inputs(idx, m)
            ys.append(y_i)
            cov[:, i0:i1, i0:i1] = c_i
        return torch.cat(ys, dim=1).contiguous(), cov

    return stitched


def grown_inputs(stitched, m, n):
    """m stitched matrices grown to n > nobs, each block-diagonal with a
    leading block of itself (and y extended the same way)."""
    import torch

    y, cov = stitched(m)
    k, extra = y.shape[1], n - y.shape[1]
    big = torch.zeros((m, n, n), dtype=torch.float32, device=cov.device)
    big[:, :k, :k] = cov
    big[:, k:, k:] = cov[:, :extra, :extra]
    return torch.cat([y, y[:, :extra]], dim=1).contiguous(), big


def mvn_phase(chain, device):
    """The MVN elimination against its plain version on the covariances the
    dense paths hand it: every flagship block size (SMEM_SIZES) at 1024
    walkers and at a half-ensemble of 512 (shared-memory route: its warp
    kernel to n = 32, its block kernel past it), the stitched 544 x 544
    matrix at a half-ensemble of 512 and 16 stitched matrices grown to
    n = 767 (each one block-diagonal with a leading block of itself; both
    the wide route, "panel"), one matrix of each
    batch replaced by a non-PD one.  Each case goes through the wrapper's
    own choice of route, which must be the one named.  The kernel is timed
    by CUDA-graph replay (:func:`graph_ms`); the plain version and the
    library yardstick, the port's ``mvn_loglike_batch`` (``cholesky_ex`` +
    ``solve_triangular`` + reductions), with CUDA events around their eager
    calls."""
    block_inputs = mvn_inputs(chain, device)
    stitched = stitched_inputs(chain, device, block_inputs)
    cases = tuple(("fused_mvn_loglike", block_inputs(BLOCKS.index(n), b), 9)
                  for b in (NWALKERS, NWALKERS // 2) for n in SMEM_SIZES) + (
        ("fused_mvn_loglike_panel", stitched(NWALKERS // 2), 4),
        ("fused_mvn_loglike_panel", grown_inputs(stitched, 16, GROWN_N), 4),
    )
    return mvn_cases(cases, device)


def wide_mvn_phase(chain, device):
    """The wide route on the stitched-wide chain's own covariances: the
    half-ensemble (512, 1088) the path hands it (the float32 plain column
    loop on the first 16 matrices, the float64 one on all 512), and two
    of them grown to n = 2048, past the route's old cap; one non-PD matrix
    planted in each batch.  Returns the (512, 1088) case's numbers, the
    other's under "also"."""
    import torch

    block_inputs = mvn_inputs(chain, device, WIDE_BLOCKS)
    stitched = stitched_inputs(chain, device, block_inputs, WIDE_BLOCKS)
    name = "fused_mvn_loglike_panel"
    t0 = time.perf_counter()
    stats = mvn_cases(((name, stitched(NWALKERS // 2), 2),), device, n_plain=WIDE_PLAIN)
    torch.cuda.empty_cache()
    also = mvn_cases(((name, grown_inputs(stitched, 2, 2048), 2),), device)[name]
    stats[name]["also"] = [also]
    log(f"wide MVN checks: {time.perf_counter() - t0:.1f} s")
    return stats


def mvn_cases(cases, device, n_plain=None):
    """Each case (route, (y, cov), reps) through the wrapper's own choice of
    route, which must be the one named, against its plain version (on the
    first ``n_plain`` matrices where given: the plain column loop is slow),
    the float64 elimination (on all) and the library yardstick, one matrix
    replaced by a non-PD one; timed as :func:`mvn_phase` says.  Returns
    each route's first case's numbers."""
    import torch
    from gpbayestools_hic_tpu_torch.ops import fused_mvn as fm
    from gpbayestools_hic_tpu_torch.ops import registry
    from gpbayestools_hic_tpu_torch.ops.linalg import mvn_loglike_batch

    stats, failed = {}, []
    for name, (y, cov), reps in cases:
        b, n = y.shape
        bp = b if n_plain is None else min(b, n_plain)
        bad = bp // 2
        cov[bad] = -torch.eye(n, device=device)
        before = registry.LAUNCH_COUNTS[name]
        got = fm.fused_mvn_loglike(y, cov)
        torch.cuda.synchronize()
        if registry.LAUNCH_COUNTS[name] != before + 1:
            raise SystemExit(f"n = {n} did not take the route {name}")
        plain = fm.fused_mvn_loglike_plain(y[:bp], cov[:bp])
        lib = mvn_loglike_batch(y, cov)
        plain64 = fm.fused_mvn_loglike_plain(y.double(), cov.double())
        keep = torch.arange(b, device=device) != bad
        if not (got[bad] == -torch.inf and plain[bad] == -torch.inf
                and plain64[bad] == -torch.inf and torch.isfinite(got[keep]).all()):
            raise SystemExit(f"{name} (b={b}, n={n}): the planted non-PD matrix must "
                             "give -inf and every other matrix a finite value")
        e_p, r_p = normwise(got[:bp][keep[:bp]], plain[keep[:bp]])
        e_64, r_64 = normwise(got[keep], plain64[keep])
        e_l64, _ = normwise(lib[keep], plain64[keep])
        del plain64
        t_k = graph_ms(lambda: fm.fused_mvn_loglike(y, cov), reps=2 * reps)
        # the plain column loop on a whole large batch takes seconds: one rep
        t_p = cuda_ms(lambda: fm.fused_mvn_loglike_plain(y, cov),
                      reps=min(reps, 3) if n_plain is None else 1)
        t_l = cuda_ms(lambda: mvn_loglike_batch(y, cov), reps=reps)
        flops, nbytes = mvn_work(b, n, n_bad=1)
        bd32, why32 = bound_ms(flops, nbytes)
        bd, why = bd32, why32
        if name == "fused_mvn_loglike_panel":
            # the bound of the work as the wide route does it: its trailing
            # updates in three TF32 passes, the rest in FP32
            fl32, tc, _ = wide_work(b, n, fm.wide_info(b, n)["p"], n_bad=1)
            bd, why = bound_ms(fl32, nbytes, tc)
        log(f"kernel {name} vs plain (b={b}, n={n}, non-PD planted at {bad}): max abs "
            f"{e_p:.3e} (normwise {r_p:.3e}, on the first {bp} matrices; tolerance "
            f"{TOL_MVN:g} normwise -- float32 both sides, other operation order); vs the "
            f"float64 elimination on all {b}: max abs {e_64:.3e} (normwise {r_64:.3e}; "
            f"library call: {e_l64:.3e}); max |lp| {float(plain[keep[:bp]].abs().max()):.1f}")
        if name == "fused_mvn_loglike":
            log(f"occupancy {name} (n={n}): {fm.smem_matrices_per_sm(n)} matrices per SM, "
                f"panel width {fm.smem_panel()}, warp kernel up to n = {fm.WARP_MAX_N}")
            blocked = (f"one warp per matrix up to n = {fm.WARP_MAX_N}, past it blocked, "
                       f"{fm.smem_panel()}-column panels in shared memory with look-ahead")
        else:
            info = fm.wide_info(b, n)
            log(f"occupancy {name} (b={b}, n={n}, {info['sms']} SMs): clusters of C = "
                f"{info['c']} CTAs, built for {info['ctas_per_sm']} CTAs per SM, panel width "
                f"P = {info['p']}, {info['bytes']} B of shared memory per CTA, "
                f"{info['scratch']} floats of scratch per matrix, {info['active_clusters']} clusters "
                f"placed at once (cudaOccupancyMaxActiveClusters)")
            blocked = (f"blocked, {info['p']}-column panels in {info['c']}-CTA clusters, "
                       f"trailing update in device memory on the tensor cores")
        log(f"timing {name} (b={b}, n={n}): kernel {t_k:.4f} ms by CUDA-graph replay "
            f"({flops / t_k / 1e9:.2f} TFLOP/s, {nbytes / t_k / 1e6:.1f} GB/s), plain "
            f"{t_p:.4f} ms, library yardstick (mvn_loglike_batch: cholesky_ex + "
            f"solve_triangular) {t_l:.4f} ms (both CUDA events), bound {bd:.4f} ms ({why}; "
            f"all in FP32: {bd32:.4f} ms, {why32})")
        if not (r_p <= TOL_MVN and r_64 <= TOL_MVN):
            failed.append(f"{name} (b={b}, n={n})")
        # the kernels line reports each route at its first case, the others
        # under "also"
        if name in stats:
            stats[name].setdefault("also", []).append(
                dict(shape=[b, n], ms=t_k, plain_ms=t_p, bound_ms=bd, bound_by=why,
                     library_ms=t_l, max_abs_err=e_p, max_abs_err_f64=e_64))
        else:
            precision = ("3xTF32 tensor cores for the trailing updates (FP32 promotion per "
                         "step), FP32 FMA for the rest" if name == "fused_mvn_loglike_panel"
                         else "FP32 FMA")
            stats[name] = dict(max_abs_err=e_p, ms=t_k, plain_ms=t_p, bound_ms=bd,
                               bound_by=why, fp32_bound_ms=bd32, library_ms=t_l,
                               library_tf32_ms=None, precision=f"{precision} ({blocked})",
                               shape=[b, n], max_abs_err_f64=e_64,
                               timing="CUDA-graph replay (kernel), CUDA events (plain, library)")
    if failed:
        raise SystemExit(f"MVN kernel disagrees with its plain version: {failed}")
    return stats


def check_posterior(chain, x, lp64, label, others=(), gate=None):
    """log_posterior on all walkers in the chain's current mode: finite,
    within the gate of the float64 oracle on the first points, and its
    distance to the values of the modes in ``others`` (name, values)."""
    import torch
    from gpbayestools_hic_tpu_torch.utils.validation import PRECISION_GATE

    t0 = time.perf_counter()
    lp = chain.log_posterior(x)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    chain.log_posterior(x)
    torch.cuda.synchronize()
    log(f"{label}: log_posterior on {len(x)} walkers {first:.3f} s (first call), "
        f"{time.perf_counter() - t0:.3f} s (second), finite fraction "
        f"{np.isfinite(lp).mean():.4f}")
    if lp.shape != (len(x),) or not np.isfinite(lp).all():
        raise SystemExit(f"{label}: log_posterior returned non-finite values")
    gap = float(np.abs(lp[:len(lp64)] - lp64).max())
    log(f"{label}: precision gate: max |lp_f32 - lp_f64| over {len(lp64)} points = "
        f"{gap:.4f} log-units (gate {PRECISION_GATE})")
    for name, other in others:
        log(f"{label}: max |lp - lp_{name}| over {len(x)} walkers = "
            f"{float(np.abs(lp - other).max()):.4f} log-units")
    if not gap < PRECISION_GATE:
        raise SystemExit(f"{label}: f32 posterior outside the precision gate")
    if gate is not None and not gap <= gate:
        raise SystemExit(f"{label}: f32 posterior {gap:.4f} log-units from the f64 oracle, "
                         f"above this route's {gate}")
    return lp


def hmc_run(chain, label, nwalkers, burn, steps):
    import torch

    t0 = time.perf_counter()
    res = chain.run_MCMC_HMC(nwalkers=nwalkers, nburnsteps=burn, nsteps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = float(np.isfinite(res.log_prob).mean())
    log(f"{label}: HMC, {nwalkers} walkers, warmup {burn}/phase, {steps} "
        f"production steps: wall {wall:.2f} s, scheme {res.scheme} (persist "
        f"{res.persist}), step size {res.step_size:.4f}, n_leapfrog "
        f"{res.n_leapfrog}, mean acceptance {float(np.mean(res.acceptance)):.3f}, "
        f"finite log-prob fraction {finite:.4f}")
    if res.chain.shape != (nwalkers, steps, NDIM) or finite != 1.0:
        raise SystemExit(f"{label}: HMC produced a malformed chain or non-finite log-probs")
    rep = chain.convergence_report()
    log(f"{label}: HMC convergence: max rhat {float(np.max(rep['rhat'])):.4f}, "
        f"max tau {float(np.nanmax(rep['tau'])):.2f}, ESS {rep['ess']:.0f}")
    return float(np.mean(res.acceptance))


def ensemble_run(chain, label, burn, steps):
    import torch

    t0 = time.perf_counter()
    res = chain.run_mcmc(nwalkers=NWALKERS, nburnsteps=burn, nsteps=steps,
                         move="stretch", nthin=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    finite = float(np.isfinite(res.log_prob).mean())
    log(f"{label}: run_mcmc (stretch), {NWALKERS} walkers, {burn} burn-in + {steps} "
        f"steps: wall {wall:.2f} s ({1e3 * wall / (burn + steps):.1f} ms per step), "
        f"mean acceptance {float(np.mean(res.acceptance)):.3f}, finite log-prob "
        f"fraction {finite:.4f}, mean log-prob {float(res.log_prob[:, -1].mean()):.1f}")
    stored = chain.chain
    if (res.chain.shape != (NWALKERS, steps, NDIM) or stored.shape != res.chain.shape
            or finite != 1.0 or not np.isfinite(res.chain).all()):
        raise SystemExit(f"{label}: run_mcmc produced a malformed chain or non-finite log-probs")


def hmc_auto_resume(chain, tmp):
    """Path f: run_hmc with n_leapfrog="auto" on the flagship posterior,
    then a warm start with no chain file and a resume with a warm start;
    the chain file must grow from AUTOL_STEPS to 2 AUTOL_STEPS steps and
    neither continuation may run a warmup step.  Logs the probe's
    gradients per second."""
    import pickle

    import torch

    from gpbayestools_hic_tpu_torch.samplers import hmc as phmc

    phases, real = [], phmc._mh_phase

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        phases.append((kw.get("probe", False), kw["nsteps"], kw["n_leapfrog"],
                       time.perf_counter() - t0))
        return out

    log_post, state = chain.posterior_with_state()
    phmc._mh_phase = timed
    try:
        t0 = time.perf_counter()
        res = phmc.run_hmc(log_post, chain.random_pos(AUTOL_WALKERS, seed=3), AUTOL_STEPS, 3,
                           state=state, lo=chain.min, hi=chain.max, n_leapfrog="auto",
                           l_max=AUTOL_LMAX, probe_steps=AUTOL_PROBE, warmup=AUTOL_BURN,
                           scheme="auto", device=chain.device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        phmc._mh_phase = real
    probe = [ph for ph in phases if ph[0]]
    grads = AUTOL_PROBE * AUTOL_LMAX
    log(f"hmc-auto-L: run_hmc, {AUTOL_WALKERS} walkers, warmup {AUTOL_BURN}/phase at L = "
        f"{max(AUTOL_LMAX // 2, 1)}, probe {AUTOL_PROBE} steps at L = 1..{AUTOL_LMAX}: wall "
        f"{wall:.2f} s, picked n_leapfrog {res.n_leapfrog}, scheme {res.scheme}, step size "
        f"{res.step_size:.4f}, probe {probe[0][3]:.3f} s for {grads} gradient evaluations of "
        f"{AUTOL_WALKERS} walkers ({grads / probe[0][3]:.1f} gradients per second)")
    if not (1 <= res.n_leapfrog <= AUTOL_LMAX) or not np.isfinite(res.log_prob).all():
        raise SystemExit("hmc-auto-L: bad length or non-finite log-probs")
    t0 = time.perf_counter()
    res2 = chain.run_MCMC_HMC(nsteps=AUTOL_STEPS, warm_start=res)
    res3 = chain.run_MCMC_HMC(nsteps=AUTOL_STEPS, resume=True, warm_start=res2)
    torch.cuda.synchronize()
    with open(chain.mcmc_path, "rb") as f:
        stored = pickle.load(f)["chain"]
    log(f"hmc-auto-L: warm start + resume, {AUTOL_STEPS} steps each: wall "
        f"{time.perf_counter() - t0:.2f} s, warmup steps {res2.warmup_steps} and "
        f"{res3.warmup_steps}, chain file {stored.shape}, mean acceptance "
        f"{float(np.mean(res2.acceptance)):.3f} and {float(np.mean(res3.acceptance)):.3f}")
    if (res2.warmup_steps or res3.warmup_steps
            or stored.shape != (AUTOL_WALKERS, 2 * AUTOL_STEPS, NDIM)
            or not np.isfinite(stored).all() or not np.isfinite(res3.log_prob).all()):
        raise SystemExit("hmc-auto-L: the continuation warmed up again, or the chain file "
                         "did not grow as it should")


def ptlmc_run(chain):
    """Path g: Chain.run_MCMC_PTLMC with and without gradients; the chains
    must be finite, inside the box and of the contract's shape, and no
    chain's log posterior may fall in the pre-optimization beyond
    PREOPT_TOL."""
    import torch

    for grads, nsteps in ((True, PT_STEPS), (False, PT_STEPS_NOGRAD)):
        stats = {}
        t0 = time.perf_counter()
        chain.run_MCMC_PTLMC(nsteps=nsteps, nwalkers=PT_WALKERS, ntemps=PT_TEMPS,
                             maxtemp=PT_MAXTEMP, nstartparameters=PT_STARTS,
                             use_gradients=grads, stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pre = stats["preopt"]
        drop = float(np.max(pre["lp_before"] - pre["lp_after"]))
        c = np.asarray(chain.chain)
        log(f"ptlmc (use_gradients={grads}): {PT_TEMPS + PT_WALKERS} chains, "
            f"{2 * nsteps} tuning + {nsteps} production steps: wall {wall:.2f} s; "
            f"pre-optimization {pre['iterations']} iterations, {pre['trials']} trials, "
            f"{pre['converged']}/{PT_TEMPS + PT_WALKERS} lanes converged, {pre['seconds']:.2f} s, "
            f"log posterior median {np.median(pre['lp_before']):.2f} -> "
            f"{np.median(pre['lp_after']):.2f}, largest fall {max(drop, 0.0):.2e}; jitter "
            f"accepted {stats['jitter_accepted']} lanes; {stats['ms_per_step']:.2f} ms per "
            f"step; swap acceptance {stats['swap_acceptance']:.3f}")
        if drop > PREOPT_TOL:
            raise SystemExit(f"ptlmc: the pre-optimization lowered a chain's log posterior "
                             f"by {drop:.3g} (> {PREOPT_TOL})")
        if (c.shape != (PT_WALKERS, nsteps, NDIM) or not np.isfinite(c).all()
                or not np.all((c > chain.min) & (c < chain.max))):
            raise SystemExit("ptlmc: malformed, non-finite or out-of-box chain")


def _log_smc(label, res, its, wall):
    for it in its:
        log(f"{label} iter {it['iteration']}: beta {it['beta']:.5f}, {it['steps']} MCMC steps "
            f"(accept {it['accept']:.3f}), {it['fit_steps']} flow-fit steps, flow fit "
            f"{1e3 * it['fit_s']:.1f} ms, MCMC {1e3 * it['mcmc_s']:.1f} ms, host "
            f"{1e3 * it['host_s']:.1f} ms")
    fit = sum(it["fit_s"] for it in its)
    mcmc = sum(it["mcmc_s"] for it in its)
    host = sum(it["host_s"] for it in its)
    log(f"{label}: {len(its)} iterations in {wall:.2f} s ({1e3 * wall / max(len(its), 1):.1f} ms "
        f"per iteration: flow fit {1e3 * fit / max(len(its), 1):.1f}, MCMC "
        f"{1e3 * mcmc / max(len(its), 1):.1f}, host {1e3 * host / max(len(its), 1):.1f}; the "
        f"rest is set-up and evidence), {res['samples'].shape[0]} particles, ESS "
        f"{res['ess']:.0f}, logz {res['logz']:.4f} +- {res['logz_err']:.4f} ({res['logz_source']}; "
        f"PS {res['logz_ps']:.4f} +- {res['logz_err_ps']:.4f}, IS {res['logz_is']}, khat "
        f"{res['logz_khat']}, bridge {res['logz_bridge']})")


def smc_run(chain):
    """Path h: run_smc as Chain.run_pocoMC calls it (the chain's finite
    log-likelihood, its state and its box), cut in depth (SMC_FLAGSHIP);
    then the known-evidence problem on the card."""
    import torch

    from gpbayestools_hic_tpu_torch.samplers.smc import run_smc

    its = []
    t0 = time.perf_counter()
    res = run_smc(chain.device_fns["log_likelihood"], chain.min, chain.max,
                  likelihood_state=chain._like_state, seed=42, device=chain.device,
                  stats=its, **SMC_FLAGSHIP)
    torch.cuda.synchronize()
    _log_smc("smc (flagship)", res, its, time.perf_counter() - t0)
    x, w = res["samples"], res["weights"]
    if (not np.isfinite(x).all() or not np.all((x >= chain.min) & (x <= chain.max))
            or abs(w.sum() - 1.0) > 1e-9 or not np.isfinite(res["logz"])):
        raise SystemExit("smc: non-finite or out-of-box samples, weights not summing to 1, "
                         "or a non-finite logz")
    known_evidence(chain.device)


def known_evidence(device):
    """SMC on the card to n_total on a normalized 17-d correlated Gaussian
    likelihood well inside the unit box (KE_KNOBS).  The importance-sampling
    estimate must land within KE_SIGMAS of its errors plus KE_SLACK of the
    truth, its error inflated as ``_select_evidence`` inflates it when the
    weights' tail index khat exceeds 0.7.  The selected ``logz`` and the
    persistent-sampling estimate are logged against the truth: on this
    problem the persistent-sampling estimate is biased by several units in
    both packages (``tools/smc_evidence_gap.py``), and ``logz`` is that
    estimate whenever the importance-sampling one does not survive the
    3-sigma cross-check."""
    import torch

    from gpbayestools_hic_tpu_torch.samplers.smc import (
        EVIDENCE_KHAT_ERR_INFLATE, EVIDENCE_KHAT_MAX, run_smc)
    from gpbayestools_hic_tpu_torch.utils.synthetic import gaussian_evidence_problem

    prob = gaussian_evidence_problem(KE_NDIM, seed=0)
    truth = prob["truth"]
    prec = torch.tensor(prob["prec"], dtype=torch.float32, device=device)
    mean = torch.tensor(prob["mu"], dtype=torch.float32, device=device)
    const = prob["const"]

    def logl(state, x, finite):
        r = x - mean
        return -0.5 * ((r @ prec) * r).sum(1) + const

    its = []
    t0 = time.perf_counter()
    res = run_smc(logl, np.zeros(KE_NDIM), np.ones(KE_NDIM), seed=0, device=device, stats=its,
                  **KE_KNOBS)
    torch.cuda.synchronize()
    _log_smc("smc (known evidence)", res, its, time.perf_counter() - t0)
    khat = res["logz_khat"]
    err_is = res["logz_err_is"] * (EVIDENCE_KHAT_ERR_INFLATE if khat is not None
                                   and khat > EVIDENCE_KHAT_MAX else 1.0)
    gap = abs(res["logz_is"] - truth)
    log(f"smc (known evidence): {KE_NDIM}-d Gaussian, {KE_KNOBS}: truth {truth:.6f}; IS "
        f"{res['logz_is']:.4f} +- {err_is:.4f} (khat {khat}), |gap| {gap:.4f} (allowed "
        f"{KE_SIGMAS} x err + {KE_SLACK} = {KE_SIGMAS * err_is + KE_SLACK:.4f}); logz "
        f"{res['logz'] - truth:+.4f} +- {res['logz_err']:.4f} ({res['logz_source']}), PS "
        f"{res['logz_ps'] - truth:+.4f} +- {res['logz_err_ps']:.4f}, bridge "
        f"{(res['logz_bridge'] or float('nan')) - truth:+.4f} against the truth")
    if gap > KE_SIGMAS * err_is + KE_SLACK:
        raise SystemExit("smc: the importance-sampling evidence misses the known evidence "
                         "beyond its error")


def drive_paths(chain, tmp, on_paths):
    """The seven paths on the flagship chain (a-d, f-h), each between a
    reset and a reading of the launch counts; adds the kernels each path
    must launch to ``on_paths``.
    Returns ``{path: {kernel: launches}}``."""
    from gpbayestools_hic_tpu_torch.ops import registry
    from gpbayestools_hic_tpu_torch.utils.validation import f64_log_posterior

    x = chain.random_pos(NWALKERS, seed=2)
    lp64 = f64_log_posterior(chain, x[:N_ORACLE])
    values, accept = {}, {}

    def auto_hmc():
        values["auto"] = check_posterior(chain, x, lp64, "auto", gate=AUTO_GATE)
        hmc_run(chain, "auto", NWALKERS, HMC_BURN, HMC_STEPS)
        accept["default"] = hmc_run(chain, "grad_precision=default", HIGH_WALKERS,
                                    HIGH_BURN, HIGH_STEPS)

    def generic():
        chain.likelihood_mode = "generic"
        values["generic"] = check_posterior(chain, x, lp64, "generic",
                                            [("auto", values["auto"])])
        ensemble_run(chain, "generic", ENS_BURN, ENS_STEPS)

    def stitched():
        chain.likelihood_mode = "stitched"
        check_posterior(chain, x, lp64, "stitched", [("generic", values["generic"]),
                                                     ("auto", values["auto"])])
        ensemble_run(chain, "stitched", STITCHED_STEPS, STITCHED_STEPS)

    def hmc_high():
        chain.likelihood_mode = "auto"
        for e in chain.emuList:
            e.gp_grad_precision = "high"
            e.gp_config = e.gp_config._replace(grad_precision="high")
        accept["high"] = hmc_run(chain, "grad_precision=high", HIGH_WALKERS, HIGH_BURN,
                                 HIGH_STEPS)

    def default_precision():
        for e in chain.emuList:
            e.gp_grad_precision = "default"
            e.gp_config = e.gp_config._replace(grad_precision="default")

    def hmc_auto():
        default_precision()
        hmc_auto_resume(chain, tmp)

    paths = (
        ("auto+hmc", auto_hmc, ("fused_predict_fwd", "fused_predict_bwd") + WOODBURY),
        ("generic+ensemble", generic, ("fused_predict_fwd", "fused_mvn_loglike")),
        ("stitched+ensemble", stitched, ("fused_predict_fwd", "fused_mvn_loglike_panel")),
        ("hmc grad_precision=high", hmc_high,
         ("fused_predict_fwd", "fused_predict_bwd_high") + WOODBURY),
        ("hmc-auto-L+resume", hmc_auto, ("fused_predict_fwd", "fused_predict_bwd") + WOODBURY),
        ("ptlmc", lambda: ptlmc_run(chain), ("fused_predict_fwd", "fused_predict_bwd") + WOODBURY),
        ("smc", lambda: smc_run(chain), ("fused_predict_fwd", "fused_woodbury_fwd")),
    )
    counts = {}
    for name, run, kernels in paths:
        on_paths.update(kernels)
        # each path writes its own chain file: run_mcmc resumes from one it finds
        chain.mcmc_path = Path(tmp) / name.split()[0].replace("+", "_") / "chain.pkl"
        chain.mcmc_path.parent.mkdir(parents=True, exist_ok=True)
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        run()
        counts[name] = dict(registry.LAUNCH_COUNTS)
        log(f"path {name}: {time.perf_counter() - t0:.1f} s, kernel launches {counts[name]}")
        missing = [k for k in kernels if counts[name][k] == 0]
        if missing:
            raise SystemExit(f"path {name} never launched {missing}")
    if counts["hmc grad_precision=high"]["fused_predict_bwd"] != 0:
        raise SystemExit("grad_precision='high' still ran the fast backward")
    if any(counts[p]["fused_predict_bwd_high"] for p in ("hmc-auto-L+resume", "ptlmc")):
        raise SystemExit("paths f and g ran the full-precision backward, not the fast one")
    log(f"HMC mean acceptance at {HIGH_WALKERS} walkers, same seed and steps: "
        f"grad_precision=default {accept['default']:.3f}, high {accept['high']:.3f} "
        f"(the default may be at most {MAX_ACCEPT_DROP} below)")
    if accept["default"] < accept["high"] - MAX_ACCEPT_DROP:
        raise SystemExit("the fast backward's gradients cost HMC too much acceptance")
    return counts


def drive_wide_path(chain, tmp):
    """The fifth path, "stitched-wide+ensemble", between a reset and a
    reading of the launch counts: the stitched f32 log-posterior of the
    1088-observable chain on 1024 walkers within the gate of the float64
    oracle, then run_mcmc (1024 walkers, 4 + 4 steps).  It must launch the
    wide route at (512, 1088) (the batch shapes the kernel wrapper saw are
    recorded)."""
    from gpbayestools_hic_tpu_torch.ops import fused_mvn as fm
    from gpbayestools_hic_tpu_torch.ops import registry
    from gpbayestools_hic_tpu_torch.utils.validation import f64_log_posterior

    name = "stitched-wide+ensemble"
    chain.likelihood_mode = "stitched"
    chain.mcmc_path = Path(tmp) / "stitched_wide" / "chain.pkl"
    chain.mcmc_path.parent.mkdir(parents=True, exist_ok=True)
    x = chain.random_pos(NWALKERS, seed=2)
    lp64 = f64_log_posterior(chain, x[:N_ORACLE])
    shapes, launch = set(), fm._mvn_cuda

    def recorded(y, cov, route=None):
        shapes.add(tuple(y.shape))
        return launch(y, cov, route)

    fm._mvn_cuda = recorded
    try:
        registry.reset_launch_counts()
        t0 = time.perf_counter()
        check_posterior(chain, x, lp64, name)
        ensemble_run(chain, name, WIDE_STEPS, WIDE_STEPS)
        counts = dict(registry.LAUNCH_COUNTS)
    finally:
        fm._mvn_cuda = launch
    log(f"path {name}: {time.perf_counter() - t0:.1f} s, kernel launches {counts}, "
        f"MVN batch shapes {sorted(shapes)}")
    if counts["fused_mvn_loglike_panel"] == 0 or (NWALKERS // 2, chain.nobs) not in shapes:
        raise SystemExit(f"path {name} never launched the wide route at "
                         f"({NWALKERS // 2}, {chain.nobs})")
    return {name: counts}


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _timed(fn):
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, time.perf_counter() - t0


def _ms(walls):
    return ", ".join(f"{1e3 * w:.1f}" for w in walls)


def shard_meshes():
    """Path j's meshes: ``make_mesh`` over up to SH_SHARDS real cards where
    the machine has two or more, else SH_SHARDS logical shards of cuda:0;
    the PTLMC step's SH_PT_SHARDS-shard mesh likewise."""
    import torch

    from gpbayestools_hic_tpu_torch.parallel import WalkerMesh, make_mesh

    n = torch.cuda.device_count()
    if n >= 2:
        return make_mesh(min(SH_SHARDS, n)), make_mesh(SH_PT_SHARDS), "real cards"
    cuda0 = torch.device("cuda", 0)
    return (WalkerMesh([cuda0] * SH_SHARDS), WalkerMesh([cuda0] * SH_PT_SHARDS),
            "logical shards of one card")


def _device_launches(mesh, kernels, label):
    """Every device of ``mesh`` launched each of ``kernels`` in the step just
    run (the registry counts per device)."""
    from gpbayestools_hic_tpu_torch.ops import registry

    per = {k: dict(registry.LAUNCHES_BY_DEVICE.get(k, {})) for k in kernels}
    log(f"sharded {label}: launches per device {per}")
    for k in kernels:
        for d in dict.fromkeys(mesh.devices):
            if per[k].get(str(d), 0) == 0:
                raise SystemExit(f"sharded {label}: {d} never launched {k}")


def _walkers_apart(xs, xu, label, max_apart):
    """Walker by walker, the largest |x_sharded - x_unsharded| over the
    chain: the walkers bit-equal, apart and apart by more than SH_RUN_ATOL
    are counted; at most ``max_apart`` of them may be that far apart."""
    d = np.abs(np.asarray(xs, np.float64) - np.asarray(xu, np.float64))
    d = d.reshape(len(d), -1).max(1)
    far = int((d > SH_RUN_ATOL).sum())
    q = np.quantile(d, [0.5, 0.9, 0.99, 1.0])
    log(f"sharded {label}: of {len(d)} walkers {int((d == 0).sum())} bit-equal to the "
        f"unsharded run's, {int((d > 0).sum())} apart, {far} apart by more than "
        f"{SH_RUN_ATOL} (at most {int(max_apart * len(d))} may be); per-walker largest "
        f"difference: median {q[0]:.2e}, 90% {q[1]:.2e}, 99% {q[2]:.2e}, max {q[3]:.2e}")
    if far > max_apart * len(d):
        raise SystemExit(f"sharded {label}: {far} of {len(d)} walkers apart from the "
                         f"unsharded run by more than {SH_RUN_ATOL}")


def sharded_path(chain, tmp, mesh, pt_mesh):
    """Path j, "sharded": the walker mesh on the fitted flagship chain, each
    step sharded and unsharded at the same seed (sharded first), the
    launch counts set to 0 before each step and read after it; the
    forward, the fast backward and the shared-memory MVN must launch on
    every device of the sharded runs' mesh.  Returns ``{kernel: launches}``
    summed over the steps."""
    import pickle

    import torch

    from gpbayestools_hic_tpu_torch.ops import registry
    from gpbayestools_hic_tpu_torch.parallel import sharded_log_prob
    from gpbayestools_hic_tpu_torch.utils.tensors import value_and_grad

    fwd, bwd, smem = "fused_predict_fwd", "fused_predict_bwd", "fused_mvn_loglike"
    total = {}
    ndim = chain.ndim

    def step(label, kernels, fn, used_mesh=mesh):
        registry.reset_launch_counts()
        out = fn()
        counts = dict(registry.LAUNCH_COUNTS)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        log(f"sharded {label}: kernel launches {counts}")
        if kernels:
            _device_launches(used_mesh, kernels, label)
        return out

    def chain_file(name):
        chain.mcmc_path = Path(tmp) / "sharded" / name / "chain.pkl"
        chain.mcmc_path.parent.mkdir(parents=True, exist_ok=True)
        return chain.mcmc_path

    # more devices than the machine has: make_mesh refuses before any work
    n_cards = torch.cuda.device_count()
    try:
        chain.run_MCMC_HMC(nsteps=1, nwalkers=SH_WALKERS, devices=max(n_cards, 1) + 1)
    except ValueError as e:
        log(f"sharded: devices={max(n_cards, 1) + 1} on a machine with {n_cards} card(s) "
            f"refused: {e}")
    else:
        raise SystemExit(f"sharded: devices={max(n_cards, 1) + 1} ran on {n_cards} card(s)")

    # (a) the auto value and gradient
    x = torch.as_tensor(chain.random_pos(SH_WALKERS, seed=11), dtype=chain._dtype,
                        device=chain.device)
    log_post, state = chain.posterior_with_state()
    sharded = sharded_log_prob(log_post, mesh, state)

    unsharded = value_and_grad(lambda q: log_post(state, q))

    def value_and_grad_turns():
        walls = {"sharded": [], "unsharded": []}
        for _ in range(SH_REPS):
            (vs, gs), t_s = _timed(lambda: sharded.value_and_grad(x))
            (vu, gu), t_u = _timed(lambda: unsharded(x))
            walls["sharded"].append(t_s)
            walls["unsharded"].append(t_u)
        return vs, gs, vu, gu, walls

    vs, gs, vu, gu, walls = step("(a) value+gradient", (fwd, bwd), value_and_grad_turns)
    vs, gs, vu, gu = (t.double().cpu().numpy() for t in (vs, gs, vu, gu))
    dv = float(np.abs(vs - vu).max() / max(np.abs(vu).max(), 1.0))
    dg = float(np.abs(gs - gu).max() / max(np.abs(gu).max(), 1e-30))
    log(f"sharded (a) auto value+gradient, {SH_WALKERS} walkers over {mesh.size} shards: "
        f"values {dv:.3e} relative (tolerance {SH_VALUE_RTOL}), gradients {dg:.3e} normwise "
        f"(tolerance {SH_GRAD_TOL}), values bit-equal {bool(np.array_equal(vs, vu))}, "
        f"gradients bit-equal {bool(np.array_equal(gs, gu))}; wall in turns (ms, the first "
        f"call of each included) sharded {_ms(walls['sharded'])}, unsharded "
        f"{_ms(walls['unsharded'])}")
    if not (np.isfinite(vs).all() and dv <= SH_VALUE_RTOL and dg <= SH_GRAD_TOL):
        raise SystemExit("sharded (a): the sharded value and gradient differ from the unsharded")

    chain.likelihood_mode = "generic"
    try:
        # (b) the generic posterior: the shared-memory MVN route on every shard
        gen_post, gen_state = chain.posterior_with_state()
        gen_sharded = sharded_log_prob(gen_post, mesh, gen_state)
        xg = x[:SH_GENERIC]

        def values_turns():
            walls = {"sharded": [], "unsharded": []}
            with torch.no_grad():
                for _ in range(SH_REPS):
                    ls, t_s = _timed(lambda: gen_sharded(xg))
                    lu, t_u = _timed(lambda: gen_post(gen_state, xg))
                    walls["sharded"].append(t_s)
                    walls["unsharded"].append(t_u)
            return ls, lu, walls

        ls, lu, walls = step("(b) generic posterior", (smem,), values_turns)
        ls, lu = ls.double().cpu().numpy(), lu.double().cpu().numpy()
        dv = float(np.abs(ls - lu).max() / max(np.abs(lu).max(), 1.0))
        log(f"sharded (b) generic posterior, {SH_GENERIC} walkers over {mesh.size} shards: "
            f"values {dv:.3e} relative (tolerance {SH_VALUE_RTOL}), bit-equal "
            f"{bool(np.array_equal(ls, lu))}; wall in turns (ms) sharded "
            f"{_ms(walls['sharded'])}, unsharded {_ms(walls['unsharded'])}")
        if not (np.isfinite(ls).all() and dv <= SH_VALUE_RTOL):
            raise SystemExit("sharded (b): the sharded generic posterior differs")

        # (d) run_mcmc in generic mode from a resumed chain
        x0 = chain.random_pos(SH_WALKERS, seed=12)
        runs = {}
        for tag, knobs in (("sharded", {"mesh": mesh}), ("unsharded", {})):
            with open(chain_file(f"ensemble_{tag}"), "wb") as f:
                pickle.dump({"chain": x0[:, None, :]}, f)
            res, wall = step(f"(d) run_mcmc {tag}", (smem,) if knobs else (), lambda: _timed(
                lambda: chain.run_mcmc(nsteps=SH_ENS_STEPS, nburnsteps=0, nwalkers=SH_WALKERS,
                                       nthin=1, seed=5, **knobs)))
            runs[tag] = res
            log(f"sharded (d) run_mcmc (generic, resumed) {tag}: {SH_WALKERS} walkers, "
                f"{SH_ENS_STEPS} steps: wall {wall:.2f} s, mean acceptance "
                f"{float(np.mean(res.acceptance)):.4f}")
        if (runs["sharded"].chain.shape != (SH_WALKERS, SH_ENS_STEPS, ndim)
                or not np.isfinite(runs["sharded"].log_prob).all()):
            raise SystemExit("sharded (d): malformed chain or non-finite log-probs")
        _walkers_apart(runs["sharded"].chain, runs["unsharded"].chain, "(d) run_mcmc",
                       SH_MAX_APART_GENERIC)
    finally:
        chain.likelihood_mode = "auto"

    # (c) windowed HMC with persistent momentum
    runs = {}
    for tag, knobs in (("sharded", {"mesh": mesh}), ("unsharded", {})):
        chain_file(f"hmc_{tag}")
        res, wall = step(f"(c) HMC {tag}", (fwd, bwd) if knobs else (), lambda: _timed(
            lambda: chain.run_MCMC_HMC(nsteps=SH_HMC_STEPS, nwalkers=SH_WALKERS,
                                       nburnsteps=SH_HMC_BURN, scheme="windowed",
                                       persist=0.7, seed=7, **knobs)))
        runs[tag] = res
        log(f"sharded (c) HMC {tag}: {SH_WALKERS} walkers, warmup {SH_HMC_BURN}/phase, "
            f"{SH_HMC_STEPS} windowed steps (persist 0.7): wall {wall:.2f} s, step size "
            f"{res.step_size:.6f}, mean acceptance {float(np.mean(res.acceptance)):.4f}")
    if (runs["sharded"].chain.shape != (SH_WALKERS, SH_HMC_STEPS, ndim)
            or not np.isfinite(runs["sharded"].log_prob).all()):
        raise SystemExit("sharded (c): malformed chain or non-finite log-probs")
    _walkers_apart(runs["sharded"].chain, runs["unsharded"].chain, "(c) HMC", 0)

    # (e) PTLMC with gradients, its chains over SH_PT_SHARDS shards
    runs = {}
    for tag, knobs in (("sharded", {"mesh": pt_mesh}), ("unsharded", {})):
        chain_file(f"ptlmc_{tag}")
        stats = {}
        _, wall = step(f"(e) PTLMC {tag}", (fwd, bwd) if knobs else (), lambda: _timed(
            lambda: chain.run_MCMC_PTLMC(**SH_PT, stats=stats, **knobs)), used_mesh=pt_mesh)
        c = runs[tag] = np.asarray(chain.chain)
        pre = stats["preopt"]
        drop = float(np.max(pre["lp_before"] - pre["lp_after"]))
        log(f"sharded (e) PTLMC {tag}: {SH_PT['ntemps'] + SH_PT['nwalkers']} chains, "
            f"{2 * SH_PT['nsteps']} + {SH_PT['nsteps']} steps: wall {wall:.2f} s, "
            f"pre-optimization {pre['iterations']} iterations, {pre['trials']} trials, "
            f"largest fall {max(drop, 0.0):.2e}; {stats['ms_per_step']:.2f} ms per step")
        if (c.shape != (SH_PT["nwalkers"], SH_PT["nsteps"], ndim) or not np.isfinite(c).all()
                or not np.all((c > chain.min) & (c < chain.max)) or drop > PREOPT_TOL):
            raise SystemExit(f"sharded (e) {tag}: malformed chain or a falling "
                             "pre-optimization")
    _walkers_apart(runs["sharded"], runs["unsharded"], "(e) PTLMC cold chains", 0)

    # (f) SMC as run_pocoMC drives it
    out = {}
    for tag, knobs in (("sharded", {"mesh": mesh}), ("unsharded", {})):
        chain_file(f"smc_{tag}")
        its = []
        res, wall = step(f"(f) pocoMC {tag}", (fwd,) if knobs else (), lambda: _timed(
            lambda: chain.run_pocoMC(random_state=3, checkpoint=False, stats=its, **SH_SMC,
                                     **knobs)))
        out[tag] = res
        split = "; ".join(f"flow fit {it['fit_s']:.2f} s, MCMC {it['mcmc_s']:.2f} s "
                          f"({it['steps']} steps), host {it['host_s']:.2f} s" for it in its)
        log(f"sharded (f) run_pocoMC {tag}: {SH_SMC}: wall {wall:.2f} s, logz "
            f"{res['logz']:.4f} +- {res['logz_err']:.4f}; per iteration: {split}")
    s, u = out["sharded"], out["unsharded"]
    err = float(np.hypot(s["logz_err"], u["logz_err"]))
    if (not np.isfinite(s["chain"]).all() or abs(s["weights"].sum() - 1.0) > 1e-6
            or not abs(s["logz"] - u["logz"]) < 3.0 * err + 0.5):
        raise SystemExit("sharded (f): non-finite samples, or logz beyond 3 combined errors "
                         "+ 0.5 of the unsharded run")
    return total


def _lanes(chain):
    """The chain's GPs as one batch: (x (n, d), y (36, n), fitted params,
    config) on the card."""
    import torch

    states = [e.gp_state for e in chain.emuList]
    params = {k: torch.cat([s.params[k] for s in states]) for k in states[0].params}
    y = torch.cat([s.y for s in states])
    return states[0].x, y, params, chain.emuList[0].gp_config


def _scipy_fit(x, y, theta0, lower, upper, ls_only_dims):
    """scipy L-BFGS-B on one RBF GP's negative log marginal likelihood in
    float64 numpy (analytic gradient), from ``theta0`` = [log_amp, log_ls
    (d), log_noise] within the bounds, run to its own convergence.  Returns
    (theta, nll, result)."""
    from scipy.linalg import cho_factor, cho_solve
    from scipy.optimize import minimize

    n, d = x.shape
    sq = [(x[:, j, None] - x[None, :, j]) ** 2 for j in range(ls_only_dims)]
    eye = np.eye(n)

    def nll_and_grad(theta):
        amp, ls, noise = np.exp(theta[0]), np.exp(theta[1:1 + d]), np.exp(theta[1 + d])
        d2 = sum(s / l**2 for s, l in zip(sq, ls))
        kr = amp * np.exp(-0.5 * d2)
        k = kr + (noise + ALPHA) * eye
        try:
            cf = cho_factor(k, lower=True)
        except np.linalg.LinAlgError:
            return 1e30, np.zeros_like(theta)
        a = cho_solve(cf, y)
        nll = 0.5 * y @ a + np.log(np.diag(cf[0])).sum() + 0.5 * n * np.log(2 * np.pi)
        w = cho_solve(cf, eye) - np.outer(a, a)     # K^-1 - a a^T
        wk = w * kr
        g = np.empty_like(theta)
        g[0] = 0.5 * wk.sum()
        for j in range(d):
            g[1 + j] = 0.5 * (wk * sq[j]).sum() / ls[j] ** 2
        g[1 + d] = 0.5 * noise * np.trace(w)
        return nll, g

    res = minimize(nll_and_grad, theta0, jac=True, method="L-BFGS-B",
                   bounds=list(zip(lower, upper)), options={"maxiter": 15000})
    return res.x, float(res.fun), res, nll_and_grad


def training_phase(tmp, device):
    """Phase "training": the flagship chain built by joint training on the
    card (36 RBF GPs, n = 1000, float32, gp_maxiter=30, seed 0, as the JAX
    package's bench fits it), then its checks.  Returns the chain."""
    import torch
    from gpbayestools_hic_tpu_torch.models import gp as gpm
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    log(f"training: TF32 matmuls allowed: {torch.backends.cuda.matmul.allow_tf32}")
    torch.cuda.synchronize(device)      # the context exists before its counters reset
    torch.cuda.reset_peak_memory_stats(device)
    fit = {}
    t0 = time.perf_counter()
    chain, train_s = build_synthetic_chain(
        nev=NEV, ndim=NDIM, nobs_blocks=BLOCKS, npc=NPC, gp_maxiter=FIT_MAXITER,
        seed=0, tmpdir=tmp, device=device, fit_stats=fit,
    )
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    iters = fit["iterations"]
    log(f"training: flagship chain, {len(chain.emuList)} emulators x {NPC} GPs = "
        f"{len(chain.emuList) * NPC} RBF GPs on {NEV} points (d = {NDIM}), "
        f"{chain.nobs} observables, float32, gp_maxiter={FIT_MAXITER}, seed 0")
    log(f"training: joint fit wall {train_s:.2f} s (synchronized; chain build "
        f"{time.perf_counter() - t0:.2f} s), L-BFGS iterations {iters}, line-search "
        f"trials {fit['trials']} (batched objective evaluations), converged lanes "
        f"{fit['converged']}/{len(chain.emuList) * NPC}, host synchronisations "
        f"{fit['host_syncs']} ({fit['host_syncs'] / max(iters, 1):.2f} per iteration), "
        f"peak device memory {peak:.2f} GiB")

    # each GP's LML at the initialization and at the fit, by one function
    # (gp_nll on the 36-lane batch, as the optimizer evaluated it)
    x, y, params, cfg = _lanes(chain)
    b, d = y.shape[0], x.shape[1]
    theta0, lower, upper = gpm._start_and_bounds(np.ones(d), cfg, x.dtype, device)
    theta_fit = gpm._pack(params)
    init = gpm._unpack(torch.clamp(theta0, lower, upper).expand(b, -1), d)
    zeros = torch.zeros_like(y)
    with torch.no_grad():
        lml0 = -gpm.gp_nll(init, x, y, cfg, zeros).cpu().numpy()
        lml1 = -gpm.gp_nll(gpm._unpack(theta_fit, d), x, y, cfg, zeros).cpu().numpy()
    state_lml = torch.cat([e.gp_state.lml for e in chain.emuList]).cpu().numpy()
    np.set_printoptions(precision=2, suppress=True, linewidth=160)
    log(f"training: LML at the initialization, per GP:\n{lml0}")
    log(f"training: LML at the fit, per GP:\n{lml1}")
    log(f"training: LML gain min {float((lml1 - lml0).min()):.3f}, median "
        f"{float(np.median(lml1 - lml0)):.3f}; fitted state's LML (jitter-rescued "
        f"factor) against gp_nll's: max |diff| {float(np.abs(state_lml - lml1).max()):.4f}")
    if not (np.isfinite(lml1).all() and (lml1 >= lml0).all()):
        raise SystemExit("training: a fitted LML is non-finite or below its initialization's")

    # float32 against float64 gp_nll and gradient at the fitted point
    def nll_grad(dtype):
        th = theta_fit.detach().to(dtype).requires_grad_(True)
        f = gpm.gp_nll(gpm._unpack(th, d), x.to(dtype), y.to(dtype), cfg)
        (g,) = torch.autograd.grad(f.sum(), th)
        return f.detach().double(), g.double()

    f32, g32 = nll_grad(torch.float32)
    f64, g64 = nll_grad(torch.float64)
    val_err = (f32 - f64).abs() / f64.abs().clamp(min=NEV)
    grad_err = (g32 - g64).abs().amax(-1) / NEV
    log(f"training: float32 gp_nll against float64 at the fit: max |diff| / max(|nll|, n) "
        f"= {float(val_err.max()):.2e} (tolerance {TOL_NLL32}); gradient max |diff| / n "
        f"= {float(grad_err.max()):.2e} (tolerance {TOL_NLL32_GRAD}); |nll64| "
        f"{float(f64.abs().min()):.1f} to {float(f64.abs().max()):.1f}, max |grad64| "
        f"{float(g64.abs().max()):.3f}")
    if not (float(val_err.max()) <= TOL_NLL32 and float(grad_err.max()) <= TOL_NLL32_GRAD):
        raise SystemExit("training: float32 gp_nll or its gradient off float64 at the fit")

    # scipy L-BFGS-B in float64 against the port's fits at maxiter=200: the
    # float64 fit within the JAX test's margin, the float32 fit where the
    # JAX package's float32 fit stops
    picks = [NPC * i for i in SCIPY_EMULATORS]        # GP 0 of emulators 0, 3, 8
    ys = y[picks]
    fits = {}
    for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
        t0 = time.perf_counter()
        st = {}
        fits[name] = gpm.gp_fit(x.to(dtype), ys.to(dtype), np.ones(d), config=cfg,
                                maxiter=200, stats=st)
        torch.cuda.synchronize()
        log(f"training: port {name} fit of GP 0 of emulators {SCIPY_EMULATORS} at "
            f"maxiter=200: {time.perf_counter() - t0:.2f} s, {st['iterations']} iterations, "
            f"{st['trials']} trials")
    xn = x.double().cpu().numpy()
    th0 = theta0.double().cpu().numpy()
    lo, hi = lower.double().cpu().numpy(), upper.double().cpu().numpy()
    bad = []
    for k, emu in enumerate(SCIPY_EMULATORS):
        yk = ys[k].double().cpu().numpy()
        t0 = time.perf_counter()
        _, nll_sp, res, f = _scipy_fit(xn, yk, th0, lo, hi, d)
        lml = {name: -f(gpm._pack({n: v[k] for n, v in st.params.items()})
                        .double().cpu().numpy())[0] for name, st in fits.items()}
        gap64, gap32 = -nll_sp - lml["float64"], -nll_sp - lml["float32"]
        ref_gap = abs(lml["float32"] - JAX_F32_LML[k])
        log(f"training: emulator {emu} GP 0: scipy L-BFGS-B (float64) LML {-nll_sp:.4f} "
            f"({res.nit} iterations, {res.nfev} evaluations, {time.perf_counter() - t0:.1f} s); "
            f"port float64 fit {lml['float64']:.4f} (scipy - port {gap64:.4f}, at most "
            f"{SCIPY_MARGIN}); port float32 fit {lml['float32']:.4f} (scipy - port "
            f"{gap32:.4f}; the JAX package's float32 fit {JAX_F32_LML[k]:.4f}, "
            f"|port - JAX| {ref_gap:.4f}, at most {TOL_F32_REF})")
        if not (gap64 <= SCIPY_MARGIN and ref_gap <= TOL_F32_REF):
            bad.append(emu)
    if bad:
        raise SystemExit(f"training: the fit of GP 0 of emulators {bad} is off scipy's "
                         "(float64) or off the JAX package's float32 fit")
    return chain, {"fit_s": train_s, **fit, "peak_gib": peak}


def held_to_cpu(label, card, cpu64, cpu32):
    """Each named output computed on the card (float32) against the same
    emulator loaded on the CPU in float64, normwise: at most PCA_VS_CPU32
    times the error of its float32 load on the CPU.  Returns the card's
    errors."""
    import torch

    def tensor(a):
        return (a.detach().cpu() if torch.is_tensor(a)
                else torch.tensor(np.asarray(a), dtype=torch.float64))

    bad, errs = {}, {}
    for k in cpu64:
        want = tensor(cpu64[k])
        err = normwise(tensor(card[k]), want)[1]
        err32 = normwise(tensor(cpu32[k]), want)[1]
        log(f"{label}: {k}: card float32 against the CPU float64 load {err:.2e} "
            f"normwise; the CPU float32 load {err32:.2e} (at most {PCA_VS_CPU32:g} times "
            "that)")
        errs[k] = err
        if not err <= PCA_VS_CPU32 * max(err32, 1e-7):
            bad[k] = err
    if bad:
        raise SystemExit(f"{label}: the card disagrees with float64: {bad}")
    return errs


def param_pca_check(tmp, device):
    """An emulator with parameterTrafoPCA=True trained on the card (float32):
    predict, predict_pc_raw and predict_pc_raw_fastgrad (the transform
    before the fused op) on 64 points against the same emulator loaded on
    the CPU in float64; then sample_y on the card."""
    import pickle

    import torch
    from gpbayestools_hic_tpu_torch.models import Emulator

    rng = np.random.default_rng(5)
    nev, ndim, nobs = PCA_NEV, 20, 28
    lo, hi = np.zeros(ndim), np.ones(ndim)
    lo[15:19], hi[15:19] = 0.01, 0.3        # zeta/s(T)
    lo[12:15], hi[12:15] = 0.01, 0.4        # eta/s(mu_B)
    lo[2:5], hi[2:5] = 0.5, 3.0             # y_loss(y_init)
    design = lo + (hi - lo) * rng.uniform(size=(nev, ndim))
    base = 2.0 + np.sin(design @ rng.uniform(0.2, 0.8, size=(ndim, nobs)))
    pkl, par = os.path.join(tmp, "pca_train.pkl"), os.path.join(tmp, "pca_pars.txt")
    with open(pkl, "wb") as f:
        pickle.dump({str(i): {"parameter": design[i],
                              "obs": np.stack([base[i], 0.01 * np.abs(base[i])])}
                     for i in range(nev)}, f)
    with open(par, "w") as f:
        f.write("".join(f"p{i}: $p_{i}$, {lo[i]}, {hi[i]}\n" for i in range(ndim)))
    t0 = time.perf_counter()
    e = Emulator(pkl, par, npc=NPC, gp_maxiter=FIT_MAXITER, parameterTrafoPCA=True,
                 device=device)
    e.trainEmulatorAutoMask()
    torch.cuda.synchronize()
    log(f"parameter PCA: {nev} events, 20 parameters -> {e.gp_state.x.shape[1]} after the "
        f"transform (PCs per group {e.param_pca_state.npcs}), {NPC} GPs trained on the card "
        f"in {time.perf_counter() - t0:.2f} s; fused state: {e._fused is not None}")
    p = e.gp_state.params
    log("parameter PCA: fitted amp " + str(np.exp(p["log_amp"].cpu().numpy()).round(3))
        + ", noise " + str(np.exp(p["log_noise"].cpu().numpy()).round(4))
        + f", length scales {float(p['log_ls'].exp().min()):.3f} to "
        f"{float(p['log_ls'].exp().max()):.3f}")
    path = os.path.join(tmp, "pca_emu.pkl")
    e.save(path)
    ref = Emulator.load(path, device="cpu", dtype=torch.float64)
    cpu32 = Emulator.load(path, device="cpu", dtype=torch.float32)
    X = lo + (hi - lo) * rng.uniform(size=(64, ndim))

    def outputs(emu, dtype, dev):
        xt = torch.tensor(X, dtype=dtype, device=dev)
        mean, cov = emu.predict(X)
        out = {"predict mean": mean, "predict cov": cov}
        with torch.no_grad():
            for name in ("predict_pc_raw", "predict_pc_raw_fastgrad"):
                gm, gv = getattr(emu, name)(xt)
                out[f"{name} mean"], out[f"{name} var"] = gm.cpu(), gv.cpu()
        return {k: torch.as_tensor(v) for k, v in out.items()}

    held_to_cpu("parameter PCA", outputs(e, torch.float32, device),
                outputs(ref, torch.float64, "cpu"), outputs(cpu32, torch.float32, "cpu"))
    draws = e.sample_y(X[:8], n_samples=16, random_state=0)
    log(f"sample_y on the card: shape {draws.shape}, finite {np.isfinite(draws).all()}")
    if draws.shape != (8, 16, nobs) or not np.isfinite(draws).all():
        raise SystemExit("sample_y on the card returned malformed or non-finite draws")


def band_kernel_check(chain, emus, cpu64, x, work, device):
    """Path i's kernels at path i's shapes, after its launch counts are read
    (so these launches do not count).  Each BAND head's fused state (b = its
    kept PCs, 11 to 70; the PCSK per-design noise in linv and alpha, the
    scalar learned noise in kdiag) at the HMC batch's points: the forward
    and the fast backward against their plain versions and float64
    (``hold_fused``).  Then the gradient HMC takes, of the nine heads'
    posterior on the first N_ORACLE points: the card's (the fused kernels)
    and the card's plain float32 one, against a CPU float64 chain over the
    heads' float64 copies (the plain path), within AN_GRAD_TOL normwise.
    Returns the per-head errors for the kernels line."""
    import torch
    from gpbayestools_hic_tpu_torch.samplers import Chain

    rng = np.random.default_rng(AN_SEED + 1)
    xq_all = torch.tensor(x, dtype=torch.float32, device=device)
    heads = {"fused_predict_fwd": [], "fused_predict_bwd": []}
    for i, e in enumerate(emus):
        xq = e._transform_x(xq_all).contiguous()
        b, m = e._fused.xs.shape[0], xq.shape[0]
        ct_mean = torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32, device=device)
        ct_qf = torch.tensor(rng.normal(size=(b, m)), dtype=torch.float32, device=device)
        e_fwd, errs, e_g, _ = hold_fused(e._fused, xq, ct_mean, ct_qf, f"path i, head {i} ",
                                         high=False)
        heads["fused_predict_fwd"].append(dict(b=b, m=m, max_abs_err=e_fwd,
                                               normwise=errs["fwd"], normwise_f64=errs["fwd64"]))
        heads["fused_predict_bwd"].append(dict(b=b, m=m, max_abs_err=e_g,
                                               normwise_f64=errs["bwd"]))

    def grad(ch, dtype, dev):
        fn, state = ch.posterior_with_state()
        xx = torch.tensor(x[:N_ORACLE], dtype=dtype, device=dev, requires_grad=True)
        (g,) = torch.autograd.grad(fn(state, xx).sum(), xx)
        return g.double().cpu()

    ref = Chain(mcmc_path=str(work / "cpu64" / "chain.pkl"), expdata_path=str(work / "exp.pkl"),
                model_parafile=str(work / "pars.txt"), device="cpu", dtype=torch.float64)
    ref.loadEmulator(cpu64)
    g64 = grad(ref, torch.float64, "cpu")
    g_kern = grad(chain, torch.float32, device)
    fused = [e._fused for e in emus]
    for e in emus:
        e._fused = None
    try:
        g_plain = grad(chain, torch.float32, device)
    finally:
        for e, f in zip(emus, fused):
            e._fused = f
    e_k, r_k = normwise(g_kern, g64)
    _, r_p = normwise(g_plain, g64)
    log(f"path i: the posterior's gradient at {N_ORACLE} points, against the CPU float64 "
        f"chain (plain path): the card's fused kernels max abs {e_k:.3e} (normwise "
        f"{r_k:.3e}), the card's plain float32 path normwise {r_p:.3e}; tolerance "
        f"{AN_GRAD_TOL:g} normwise -- the fast backward's one TF32 pass, float32 elsewhere")
    if not (torch.isfinite(g_kern).all() and r_k <= AN_GRAD_TOL):
        raise SystemExit("path i: the posterior's gradient through the fused kernels "
                         "disagrees with float64")
    heads["posterior_gradient"] = dict(points=N_ORACLE, normwise_f64=r_k,
                                       plain_f32_normwise_f64=r_p)
    return heads


def analysis_path(tmp, device):
    """Path i, "analysis": the toolkit as one workflow on the card, between a
    reset and a reading of the launch counts.  Design (MaxPro LHS, 1000 x
    17), joint training of nine BAND PCSK RBF heads on the synthetic smooth
    model at the design, validation of the two 170-observable heads, HMC
    over the nine heads ("auto", Woodbury: the fused kernels), closure,
    sensitivity and posterior clusters; each result held against the CPU
    float64 copy (or its own yardstick).  Returns ``{"analysis": counts}``."""
    import pickle

    import torch
    from gpbayestools_hic_tpu_torch.config import new_generator
    from gpbayestools_hic_tpu_torch.design import lhd
    from gpbayestools_hic_tpu_torch.models import Emulator, EmulatorBAND
    from gpbayestools_hic_tpu_torch.models.joint import train_emulators_jointly
    from gpbayestools_hic_tpu_torch.models.validation import validate_multiple_emulators
    from gpbayestools_hic_tpu_torch.ops import registry
    from gpbayestools_hic_tpu_torch.samplers import Chain
    from gpbayestools_hic_tpu_torch.utils import (
        delta_d, generate_posterior_clusters, percentile_params, posterior_predictive,
        sensitivity_matrix, sensitivity_matrix_fd)
    from gpbayestools_hic_tpu_torch.utils.synthetic import (
        write_exp_pickle, write_parameter_file, write_training_pickle)
    from gpbayestools_hic_tpu_torch.utils.validation import f64_log_posterior

    name = "analysis"
    work = Path(tmp) / name
    work.mkdir()
    registry.reset_launch_counts()
    t_path = time.perf_counter()

    # 1. design: the annealed LHS against the random LHS it started from
    t0 = time.perf_counter()
    design = lhd.generate_lhs(NEV, NDIM, seed=AN_SEED, cache=False, device=device)
    torch.cuda.synchronize()
    lhs_s = time.perf_counter() - t0
    start = lhd._random_lhs(new_generator(device, AN_SEED), NEV, NDIM,
                            dtype=torch.float32).double().cpu().numpy()
    latin = all(sorted(np.floor(design[:, d] * NEV).astype(int).tolist()) == list(range(NEV))
                for d in range(NDIM))
    mpd, mpd0 = lhd.min_pairwise_distance(design), lhd.min_pairwise_distance(start)
    maxpro = float(lhd._maxpro_energy(torch.tensor(design)))
    maxpro0 = float(lhd._maxpro_energy(torch.tensor(start)))
    log(f"{name}: design: MaxPro LHS {NEV} x {NDIM}, {min(20000, 200 * NEV)} annealing steps "
        f"on the card in {lhs_s:.2f} s; one point per stratum in every column: {latin}; exact min pairwise "
        f"distance {mpd0:.5f} -> {mpd:.5f}; exact log MaxPro criterion (float64, host) "
        f"{maxpro0:.4f} -> {maxpro:.4f}")
    if not (latin and mpd > mpd0 and maxpro < maxpro0):
        raise SystemExit(f"{name}: the annealed design is not Latin or not better than its start")

    # 2. training: nine PCSK RBF heads on the synthetic smooth model, jointly
    rng = np.random.default_rng(AN_SEED)
    truth = rng.uniform(0.35, 0.65, size=NDIM)
    par = write_parameter_file(work / "pars.txt", NDIM)
    pkls, exp_mean = [], []
    for b, nobs in enumerate(BLOCKS):
        freqs = rng.uniform(0.5, 2.0, size=(NDIM, nobs))
        base = 2.0 + np.sin(design @ freqs)
        pkls.append(write_training_pickle(work / f"train{b}.pkl", design, base,
                                          0.01 * np.abs(base)))
        exp_mean.append(2.0 + np.sin(truth @ freqs))
    exp_mean = np.concatenate(exp_mean)

    def head(b):
        return EmulatorBAND(str(pkls[b]), str(par), method="PCSK", kernel_kind="RBF",
                            gp_maxiter=FIT_MAXITER, device=device)

    emus = [head(b) for b in range(len(BLOCKS))]
    fit = {}
    t0 = time.perf_counter()
    train_emulators_jointly(emus, stats=fit)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    npcs = [e._npc_used for e in emus]
    log(f"{name}: training: {len(emus)} PCSK RBF heads (float32) keep {npcs} PCs ({sum(npcs)} GPs on "
        f"{NEV} points), joint fit at gp_maxiter={FIT_MAXITER} in {fit_s:.2f} s: "
        f"{fit['iterations']} iterations, {fit['trials']} batched trials, "
        f"{fit['converged']}/{sum(npcs)} lanes converged; fused state on every head: "
        f"{all(e._fused is not None for e in emus)}")
    t0 = time.perf_counter()
    paths = []
    for b, e in enumerate(emus):
        paths.append(str(work / f"band{b}.sav"))
        e.save(paths[-1])

    def cpu_copies(path):
        return (Emulator.load(path, device="cpu", dtype=torch.float64),
                Emulator.load(path, device="cpu", dtype=torch.float32))

    wide = [b for b, n in enumerate(BLOCKS) if n == 170]
    x_pred = rng.uniform(0.0, 1.0, size=(AN_PREDICT, NDIM))

    def mean_and_var(emu, x):
        mean, cov = emu.predict(x)
        return {"mean": mean, "cov diagonal": np.diagonal(cov, axis1=1, axis2=2)}

    cpu = {b: cpu_copies(paths[b]) for b in wide}
    log(f"{name}: saves of the nine heads and CPU float64 / float32 loads of blocks {wide}: "
        f"{time.perf_counter() - t0:.2f} s")
    c64, c32 = cpu[wide[0]]
    held_to_cpu(f"{name}: training, block {wide[0]} predict at {AN_PREDICT} points",
                mean_and_var(emus[wide[0]], x_pred), mean_and_var(c64, x_pred),
                mean_and_var(c32, x_pred))

    # 3. validation: fresh copies of the two 170-observable heads
    built = []

    def factory(b):
        def make():
            built.append(head(b))
            return built[-1]
        return make

    t0 = time.perf_counter()
    res = validate_multiple_emulators({f"block {b}": factory(b) for b in wide},
                                      n_test_points=AN_HOLDOUT)
    torch.cuda.synchronize()
    log(f"{name}: validation of blocks {wide} (hold out the last {AN_HOLDOUT} of {NEV}): "
        f"{time.perf_counter() - t0:.2f} s; " + "; ".join(
            f"{k}: mean E {r['mean_E']:.5f}, <log H> {r['mean_log_H']:.4f}"
            for k, r in res.items()))
    for (k, r), e in zip(res.items(), built):
        if not (np.isfinite(r["mean_E"]) and np.isfinite(r["mean_log_H"])):
            raise SystemExit(f"{name}: validation of {k} gave non-finite E or <log H>")
        path = str(work / f"valid_{k.split()[-1]}.sav")
        e.save(path)
        v64, v32 = cpu_copies(path)
        held = e.design_points_org_[-AN_HOLDOUT:]

        def holdout(emu):
            m = mean_and_var(emu, held)
            return {"held-out mean": m["mean"], "held-out sd": np.sqrt(m["cov diagonal"])}

        held_to_cpu(f"{name}: validation, {k}",
                    {"held-out mean": r["pred"], "held-out sd": r["pred_err"]},
                    holdout(v64), holdout(v32))
    del built, res

    # 4. sampling: HMC over the nine heads on pseudo-data at the truth
    exp_err = AN_EXP_NOISE * np.abs(exp_mean)
    exp_pkl = write_exp_pickle(work / "exp.pkl", exp_mean + exp_err * rng.normal(size=exp_mean.size),
                               exp_err)
    chain = Chain(mcmc_path=str(work / "mcmc" / "chain.pkl"), expdata_path=str(exp_pkl),
                  model_parafile=str(par), device=device)
    chain.loadEmulator(emus)
    x = chain.random_pos(AN_WALKERS, seed=2)
    t0 = time.perf_counter()
    lp64 = f64_log_posterior(chain, x[:N_ORACLE])
    log(f"{name}: float64 oracle at {N_ORACLE} points: {time.perf_counter() - t0:.2f} s")
    check_posterior(chain, x, lp64, f"{name} (auto)", gate=AUTO_GATE)
    acceptance = hmc_run(chain, name, AN_WALKERS, AN_BURN, AN_STEPS)

    # 5. closure
    t0 = time.perf_counter()
    samples = np.asarray(chain.chain)
    pct = percentile_params(samples)
    dd = delta_d(samples, truth, chain.min, chain.max)
    cpu_all = {b: cpu.get(b) or cpu_copies(paths[b]) for b in range(len(BLOCKS))}
    pp = {tag: posterior_predictive(samples, emu_list, n_draws=AN_DRAWS, seed=AN_SEED)
          for tag, emu_list in (("card", emus),
                                ("cpu64", [cpu_all[b][0] for b in range(len(BLOCKS))]),
                                ("cpu32", [cpu_all[b][1] for b in range(len(BLOCKS))]))}
    log(f"{name}: closure: Delta_d against the truth {dd:.5f} (a workflow number); median "
        f"minus truth, largest |.| {float(np.abs(pct[1] - truth).max()):.4f}; "
        f"{time.perf_counter() - t0:.2f} s with the CPU copies of every head")
    held_to_cpu(f"{name}: closure, posterior predictive ({AN_DRAWS} draws, {chain.nobs} "
                "observables)", {"predictive": pp["card"]}, {"predictive": pp["cpu64"]},
                {"predictive": pp["cpu32"]})

    # 6. sensitivity at the truth for the two 170-observable heads
    t0 = time.perf_counter()
    for b in wide:
        s_card = sensitivity_matrix(emus[b], truth)
        s_fd = sensitivity_matrix_fd(emus[b], truth, rel_step=AN_FD_STEP)
        gaps = held_to_cpu(f"{name}: sensitivity, block {b}", {"jacfwd": s_card},
                           {"jacfwd": sensitivity_matrix(cpu_all[b][0], truth)},
                           {"jacfwd": sensitivity_matrix(cpu_all[b][1], truth)})
        fd_gap = float(np.abs(s_card - s_fd).max())
        log(f"{name}: sensitivity, block {b}: shape {s_card.shape}, largest |S| "
            f"{float(np.abs(s_card).max()):.4f}; card against CPU float64 {gaps['jacfwd']:.2e} "
            f"normwise; max |jacfwd - central differences (h = {AN_FD_STEP} theta)| on the card "
            f"{fd_gap:.2e} (allowed {AN_FD_ATOL})")
        if not fd_gap <= AN_FD_ATOL:
            raise SystemExit(f"{name}: jacfwd and central differences disagree on block {b}")

    log(f"{name}: sensitivity: {time.perf_counter() - t0:.2f} s")

    # 7. posterior clusters of the HMC chain by its log-likelihood
    t0 = time.perf_counter()
    logl = chain.compute_log_likelihood_for_chain(output_path=str(work / "loglike.pkl"))
    clustered = work / "clusters.pkl"
    with open(clustered, "wb") as f:
        pickle.dump({"chain": samples.reshape(-1, NDIM), "logl": np.asarray(logl).reshape(-1)}, f)
    st_card, st_cpu = {}, {}
    centers, labels = generate_posterior_clusters(
        clustered, AN_CLUSTERS, n_top_samples=AN_TOP, output_dir=work / "card",
        device=device, stats=st_card)
    centers64, _ = generate_posterior_clusters(
        clustered, AN_CLUSTERS, n_top_samples=AN_TOP, output_dir=work / "cpu",
        device="cpu", dtype=torch.float64, stats=st_cpu)
    c_gap = float(np.abs(centers - centers64).max() / np.abs(centers64).max())
    i_gap = abs(st_card["inertia"] - st_cpu["inertia"]) / st_cpu["inertia"]
    nsamples = samples.shape[0] * samples.shape[1]
    log(f"{name}: clusters: {AN_CLUSTERS} centers of the top {AN_TOP} of {nsamples} "
        f"samples, cluster sizes {np.bincount(labels).tolist()}, inertia "
        f"{st_card['inertia']:.4f} (CPU float64 {st_cpu['inertia']:.4f}); card against CPU "
        f"float64: centers {c_gap:.2e}, inertia {i_gap:.2e} relative (allowed {AN_CLUSTER_RTOL}); "
        f"{time.perf_counter() - t0:.2f} s")
    if not (c_gap <= AN_CLUSTER_RTOL and i_gap <= AN_CLUSTER_RTOL):
        raise SystemExit(f"{name}: k-means on the card disagrees with the CPU float64 run")

    counts = dict(registry.LAUNCH_COUNTS)
    log(f"path {name}: {time.perf_counter() - t_path:.1f} s, kernel launches {counts}, "
        f"HMC mean acceptance {acceptance:.3f}")
    missing = [k for k in ("fused_predict_fwd", "fused_predict_bwd") if counts[k] == 0]
    if missing:
        raise SystemExit(f"path {name} never launched {missing}")
    t0 = time.perf_counter()
    heads = band_kernel_check(chain, emus, [cpu_all[b][0] for b in range(len(BLOCKS))], x,
                              work, device)
    log(f"{name}: the kernels at the BAND heads' shapes and the posterior's gradient: "
        f"{time.perf_counter() - t0:.2f} s")
    return {name: counts}, heads


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    # the package's per-emulator INFO lines would push this run's own lines
    # out of a captured tail; LOGLEVEL=info brings them back
    os.environ.setdefault("LOGLEVEL", "warning")
    from gpbayestools_hic_tpu_torch.ops import _build, registry
    from gpbayestools_hic_tpu_torch.utils.synthetic import build_synthetic_chain

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    secs = _build.build_all()
    log(f"kernel build: {secs} ({time.perf_counter() - t0:.1f} s wall)")
    for name, text in _build.BUILD_LOGS.items():
        log(f"--- nvcc {name} ---\n{text.strip()}")
    log(sass_evidence())

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        t0 = time.perf_counter()
        chain, fit = training_phase(tmp, device)
        log(f"phase training: {time.perf_counter() - t0:.1f} s")

        stats = kernel_phase(chain, device)
        t0 = time.perf_counter()
        stats.update(matern_phase(device))
        log(f"phase Matern kernels: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        stats.update(woodbury_phase(device))
        log(f"phase Woodbury kernels: {time.perf_counter() - t0:.1f} s")
        stats.update(mvn_phase(chain, device))
        on_paths = {"fused_mvn_loglike_panel"}
        counts = drive_paths(chain, tmp, on_paths)
        t0 = time.perf_counter()
        param_pca_check(tmp, device)
        log(f"phase parameter PCA + sample_y: {time.perf_counter() - t0:.1f} s")
        mesh, pt_mesh, kind = shard_meshes()
        log(f"path sharded: mesh {mesh} ({kind}), PTLMC mesh {pt_mesh}; card(s) {smi!r}")
        t0 = time.perf_counter()
        counts["sharded"] = sharded_path(chain, tmp, mesh, pt_mesh)
        log(f"path sharded: {time.perf_counter() - t0:.1f} s, kernel launches "
            f"{counts['sharded']}")
        # the flagship chain's device memory goes before the wide chain comes
        del chain
        gc.collect()
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        os.makedirs(os.path.join(tmp, "wide"))
        wide, train_s = build_synthetic_chain(
            nev=NEV, ndim=NDIM, nobs_blocks=WIDE_BLOCKS, npc=NPC, gp_maxiter=0,
            seed=1, tmpdir=os.path.join(tmp, "wide"), device=device,
        )
        log(f"stitched-wide chain (synthetic, the flagship's blocks twice): "
            f"{len(wide.emuList)} emulators x {NPC} GPs, nev {NEV}, {wide.nobs} "
            f"observables; emulator set-up {train_s:.2f} s (total "
            f"{time.perf_counter() - t0:.2f} s)")
        flagship_wide = stats.pop("fused_mvn_loglike_panel")
        flagship_also = flagship_wide.pop("also", [])
        stats.update(wide_mvn_phase(wide, device))
        stats["fused_mvn_loglike_panel"]["also"][:0] = [flagship_wide, *flagship_also]
        counts.update(drive_wide_path(wide, tmp))
        del wide
        gc.collect()
        torch.cuda.empty_cache()
        path_i, heads = analysis_path(tmp, device)
        counts.update(path_i)
        for k in ("fused_predict_fwd", "fused_predict_bwd"):
            stats[k]["band_heads"] = heads[k]
        stats["fused_predict_bwd"]["band_posterior_gradient"] = heads["posterior_gradient"]
    launches = {k: sum(c[k] for c in counts.values()) for k in registry.KERNELS}
    log(f"kernel launches over the ten paths: {launches}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all, the kernels' build included")
    missing = [k for k in on_paths if launches[k] == 0]
    if missing:
        raise SystemExit(f"no path launched {missing}")

    kernels = []
    for name, (source, replaces) in registry.KERNELS.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name], **stats[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
