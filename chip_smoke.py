#!/usr/bin/env python3
"""Device smoke test of the PyTorch/CUDA port (cvxpygen_tpu_torch) on one
NVIDIA GPU.

Run from the root of the repository:  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build kernels K1 (csrc/admm_shared.cu), K2 (csrc/admm_full.cu), K3
   (csrc/admm_iterate.cu), K4 (csrc/cr_solve.cu), K5
   (csrc/banded_chunk.cu), K6 (csrc/ldl_factor.cu), K7
   (csrc/ldl_inverse.cu), K8 (csrc/ldl_solve.cu), the fused kernel of K9
   and K10 (csrc/ldl_kinv.cu) and K11 (csrc/banded_iterate.cu), one nvcc
   for sm_90a each, all started together, and identify the card;
2. K1 against its plain torch version on the card, on the scaled MPC data
   (n=222, m=252) that the shared main path hands it, at B=256 (the rho
   group of the rule, 256, and pinned chunks 8, 4, 2 and 1, whose thread
   blocks hold 8, 4, 2 and 1 instances) and at the main path's B=2048 (rho
   group 1024), float32, adaptive rho on, the same chunk for both: same
   status, iterations within one check interval, x within 1e-3 * max(1,
   |x|) where the iterations agree (at most 1% may stop one check apart,
   with objectives within 1e-2); a second call bitwise equal to the first
   (the order-fixed chunk reductions); at B=2048 8 instances per thread
   block bitwise equal to the default 16; kernel and plain times, device
   launches per call, and probes;
3. the shared main path at full width: MPC H=10 through generate_code ->
   solve(method='CPG') (B=1 has no rho group: the torch loop, as in the JAX
   package; first call and the mean of five more), then
   CompiledQPSolver.solve_batch on 2048 distinct x_init with the settings
   of bench.py:142-152; K1 must have been launched, every instance solved,
   and the objective within 1e-2 of the float64 oracle on 128 instances;
4. K3 against its plain version on MPC per-instance scaled data at B=256
   (15 iterations from a zero start and from a mid-solve state; x, z, y
   within 1e-4 * max(1, |v|_inf), the largest entry of the instance's
   vector) in the resident layout (c = 2 thread blocks per instance, the
   chosen c printed) and the streaming one (two instances per block), on
   a well-conditioned batch of the portfolio shape n=130, m=172 (c = 1) at
   the same bar, on the portfolio batch itself (c = 1; this ill-conditioned
   family held to max(1e-4, twice the spread one ulp of q gives the plain
   version)), then K3's time at B=2048, whose call is held to 1e-4;
5. K2 against its plain version on the same data with the settings of
   bench.py:312-314 (the bar of phase 2): at B=256 at the main path's block
   (the TPU kernel's block rule: 8; resident, c = 2), at one instance per
   block, at block 16 and at block 32 (the streaming layout; two instances
   per thread block), at B=2048 (the timed call, held to the same bar
   against the plain version run block by block, whose batched products
   see the batch size the kernel sees, and against the plain version on the
   whole batch, where an instance on which the two plain runs disagree
   beyond the x bar counts as one at other iterations), with probes of
   where K2's time goes and the factorization's
   second yardstick over the TF32 tensor-core peak / 3), the certificate
   ||I - M X|| after the cold sweeps (MPC and portfolio, max over the
   instances) within twice that of float32 sweeps on the same inputs, and
   the portfolio batch of phase 6 with two refinement sweeps (block 16,
   resident, c = 1: equal status, iterations and x held to twice the
   spread that one ulp of q gives the plain version, since this
   ill-conditioned family's float32 iterates move with roundoff);
6. the per-instance main path at full width: the same 2048 MPC instances
   through solve_batch(theta, shared_PA=False) with use_pallas='full' (K2)
   and 'auto' (K3 once per check interval) with 12 warm Newton-Schulz
   sweeps, each solving every instance within the oracle parity bar; the K3
   route at the general row's 6 sweeps, which leave some instances unsolved
   without refinement, on the first 512 instances, its status held to the
   torch loop at kkt_refine=0 within twice the difference that K3's plain
   version shows; a batch of 6 (B not a multiple of 8, so the reference's
   block rule gives no block) at 'auto': no K3 launch, and bitwise the
   solve with use_pallas='never' (statuses, iterations, x); and the
   portfolio family with per-instance factor
   loadings (bench.py:460-531) at B=512 through K2 at the bench's settings
   (at most 1% unsolved, since roundoff decides a few borderline instances
   there) and with a second refinement sweep (every instance solved), both
   within the oracle parity bar; each launches its kernel;
7. K4 (csrc/cr_solve.cu) against its plain version on the charging T=1440
   factor of the shared path's first factorization (nb=541, s=8) at B = 1,
   3, 256 and 2048 (K4_BATCHES), on right-hand sides b = M x of random
   x ~ N(0, 1) (every entry of x of order 1, so the bar sees each), and on
   a mid-solve call at B=256 (x within K4_TOL * max(1, |x|_inf)), each
   bitwise equal on a second call and at every pinned group of instances
   per thread block (1, 2, 4, 8); K4's time by group at B=256 and 2048, its
   L2 bytes per call, the plain version's time, the bound and
   torch.cholesky_solve of the dense Cholesky factor of the same M;
8. K5 (csrc/banded_chunk.cu) against its plain version on scaled MPC H=30
   data (nb=41, s=16, r_max=24) at B=256, from the zero start and from a
   mid-solve state with every fifth instance done, at B=257 (a partial
   last group) and at B=2048 (the bars of K5_TOL and K5_FLAG_BAND), each
   bitwise equal on a second call and at every pinned group of instances
   per thread block (1, 2, 4, 8); K5's time by group at B=256 and 2048
   with the chosen group and its L2 bytes per call, one call's time at
   B=2048 with its bound;
9. the banded main path at full width: charging T=1440 (bench.py:544-580)
   through generate_code(solver='BANDED') -> solve(method='CPG'), within
   1e-2 of the port's dense float64 ADMM at eps 1e-6 on the card, and
   CompiledBandedQPSolver.solve_batch on 256 instances (K4): at the bench's
   eps 1e-3 within 1e-2 of the dense float64 ADMM at the same eps (the
   stopping rule alone leaves up to about 1% to the optimum there, which
   the script prints), at eps 1e-4 within 1e-2 of eps 1e-6; MPC H=30
   through make_compiled_solver(fam, 'ADMM') on 2048 x_init (K5), parity
   against the float64 oracle on 16; the per-instance engine on charging
   with gamma per instance at B=64, parity against the dense per-instance
   float64 ADMM on 4; every instance solved; the largest segment of the
   banded solvers' order-fixed segment sums (their gather tables); each
   kernel's launches are
   those of one solve_batch at the bench's settings (the count set to 0
   just before it); where the time goes (each kernel's CUDA-event time
   inside one more solve, in all and per launch);
10. K6 (csrc/ldl_factor.cu), K7 (csrc/ldl_inverse.cu) and K8
   (csrc/ldl_solve.cu) against their plain versions on the KKT matrices that
   the entropy family's IPM solve hands K6 (n=32: N=161, Np=176, B=1024,
   float32), the first iteration's K and each instance's last
   (worst-conditioned) one: L, d and Linv within LDL_TOL * max(1,
   |v|_inf) per instance of the plain version's on the first, within
   twice the plain version's distance from the float64 factor on the
   last; Kinv and the x of a random b from K6's factor
   within twice their plain versions' distance from the float64
   application of that factor, both per instance by max(1, |v|_inf) and
   by the median entry's relative error; K8 in each of its layouts that
   fits (ops/ldl_kernel.py::solve_plan: resident at p = 16 up to Np =
   320, streamed always) held the same way and bitwise equal on a second
   call; the same at n=64 (N=321, Np=336, B=64: K6's device-scratch path,
   K8's streamed layout); K8 in each layout within LDL_TOL of its plain
   version on a well-conditioned K at N=161 and N=321; K6's storage rule
   (ops/ldl_kernel.py::factor_layout) held to the library's; K7 at
   B=70000 (one launch, N=7); K7 above a stage's whole block of L, at
   N=801 (L applied in chunks) and N=1601 (R in the device scratch), on a
   well-conditioned K within LDL_TOL of its plain version; K7's plan
   (ops/ldl_kernel.py::inverse_plan) and its time at each column-tile
   width on the first-iteration K and the n=64 twin, every width bitwise
   equal on the lower triangle and its whole Kinv held to the float64
   application as above; K8's time in each layout at both shapes; each
   kernel's time, its plain version's, the library call's and the
   function's bound;
11. the conic IPM main path at full width: the entropy family
   (bench.py:395-457, B=1024, c ~ N(0, 1) from default_rng(5), settings of
   bench.py:424-429) through CompiledConicSolver with K6 + K7 and with
   ldl_inverse=False (K6 + K8; its mean and largest iterations printed
   beside those of K8's first design), every instance solved and the
   objective within 1e-2 of logsumexp(c); where the time goes (K6 and K7
   by CUDA events inside one more solve); one instance through
   generate_code(solver='CLARABEL') -> solve(method='CPG'); the ADP SOCP
   family (bench.py:347-392) through the default generate_code route (the
   IPM, 'schur' mode: no kernel), solve(method='CPG') and solve_batch at
   B=1024, within 1e-2 of the float64 oracle on 16 instances, and the same
   batch through kkt_solver='ldl' with ldl_two_level=True (K6 + K7 on the
   saddle block once and on the Schur complement each iteration);
12. K9 and K10, the fused factor + inverse (one kernel, csrc/ldl_kinv.cu,
   behind two wrappers), on phase 10's first-iteration K (N=161, B=1024)
   and its n=64 twin (N=321, B=64: the factor in the device scratch):
   bitwise equal to K7 on K6's factor, both triangles; on the first K each
   within twice its float32 plain version's distance from the float64
   inverse of the pivot-regularized K (plus LDL_APPLY_FLOOR), by both
   measures; on a well-conditioned K (N=24) within FUSED_WELL_TOL of the
   float64 inverse; at N=801 and N=1601, B=4 (phase 10's well-conditioned
   K; the factor and R in the scratch) within LDL_TOL of each plain
   version and bitwise equal to K6 + K7; the layout rule (kinv_layout)
   held to the library's; times of K9 and K10 beside K6 + K7 timed in the
   same phase, the plain versions, torch.linalg.inv(K) and the bound; then
   the entropy batch of phase 11 under CPG_LDL_FUSED=1 (K9) and under
   CPG_LDL_BM_FUSED=1 (K10): every instance solved within the parity bar,
   per-instance iterations and status equal to the default K6 + K7
   route's, the fused kernel launched as often as K6 there and K6, K7, K8
   never; and the ADP batch through the two-level route under
   CPG_LDL_FUSED=1 (K9 on both levels): every instance solved within the
   parity bar, per-instance iterations and status equal to the K6 + K7
   two-level route's, and every K that route gave K9 (the saddle block
   Ktop, N=26, and the Schur complement S, N=10, at B=1024) bitwise K6 +
   K7's and within LDL_TOL of each plain version (the variables are set
   and restored inside the phase);
13. K11 (csrc/banded_iterate.cu) on charging T=1440, B=256 (phase 9's batch
   and settings; the shared engine's set-up through the port's own
   functions): from the state that 100 iterations of the K4 route reach,
   50 iterations (one check interval) at kkt_refine 0 and 1 on the
   rho-scaled state, by the launch plan's group of instances per thread
   block (printed; ops/banded_shared_kernel.py::iterate_launch_plan, its
   shared memory held to the library's), x, z, y within K11_TOL * max(1,
   |v|_inf) of its plain version and of the K4 route at the same fixed
   rho, and bitwise equal at pinned groups 1, 2 and 4; five instances at
   two per block (a partial last group) within K11_TOL of the plain
   version and bitwise equal at one per block; K11's time, its plain
   version's, the K4 route's over the same 50 iterations and the bound;
   K11's time by group at B=256 and by batch at two per block (2, 64,
   128, 256: what the blocks' shared memory traffic costs);
   K4, K11 and the float32 set-up (D_M, L_M, B0, B1, the CR factor) held
   bitwise equal across two calls, and two eps-1e-4 solves to equal mean
   iterations (the banded segment sums take no atomics);
14. the conic ADMM (the SCS route: torch, no kernel) at full width, float32,
   eps 1e-3, max_iter 20000: the entropy family of phase 11 (B=1024, c from
   default_rng(5)) through make_compiled_solver(fam, 'SCS') on the shared
   engine, every instance solved and the objective within 1e-2 of
   logsumexp(c); the same family through the default generate_code route
   (SCS) -> solve(method='CPG'), first call and the mean of five more with
   warm start; logistic regression (examples/logistic_and_sdp.py: 20
   samples, 4 features, lambda 0.1; B=1024 datasets from default_rng(0),
   so the per-instance engine) within 1e-2 of the float64 oracle on 32;
   the max-eigenvalue SDP (s=5, B=1024 symmetric A) within 1e-2 of
   eigvalsh in float64; the time of each batch and of one exp projection
   of the entropy batch (CUDA events);
15. differentiation: TorchLayer on MPC H=10 (x_init the batched
   parameter, B=256, the settings of phase 3) with K1 in the forward, then
   backward of w.U + |U|^2 / 2 (so that dtheta reads the forward's
   values), against the same layer with use_pallas='never': the output U
   within 1e-3 * max(1, |U|_inf) and dtheta within 1e-3 * max(1,
   |dtheta|_inf) on every instance (the forwards' eps) (the float32 forwards' active sets
   differ by roundoff on rows with multipliers and slacks near the
   threshold: the count and those rows' largest values are printed,
   ROADMAP.md A7), forward and backward times and K1's launches (added to
   phase 3's in the kernels line); then
   generate_code(gradient=True) -> cpg_gradient on the family of
   tests/test_codegen.py::test_gradient_package, finite and within 1e-2 of
   the CPU float64 run;
16. the conic and banded differentiation: TorchLayer on MPC H=10 (phase
   15's batch) with K1 in the forward once more (a QP family's route);
   TorchLayer on the ADP SOCP family (bench.py:347-392, B=1024, f times
   U(0.5, 1.5) from default_rng(1), phase 11's settings) through the
   default forward ('schur') and through kkt_solver='ldl',
   ldl_two_level=True (K6 + K7, their launches counted), u and df of
   w.u + |u|^2 / 2 within 1e-2 * max(1, |v|_inf) of the port's CPU float64
   run on 8 instances; the max-eigenvalue SDP (s=5, B=256) through the
   conic ADMM forward at eps 1e-5, dA within 1e-2 of v v' at the top
   eigenvector where the top eigengap is >= 0.1; generate_code(solver=
   'SCS', gradient=True) -> cpg_gradient on the exp family of
   tests/test_conic_diff_exotic.py:135-170 against the CPU float64 run
   within 1e-2; charging T=288 (tests/test_qp_diff_banded.py's family,
   n + m = 2021, B=16, eps 1e-4) through TorchLayer's banded route, and
   the banded backward against the dense float64 qp_vjp on the card on
   the same forward's x, y, z within 1e-3; charging T=1440 (phase 9's
   family, n + m = 14405, B=8, eps 1e-4) through the banded route, its
   forward and backward times and peak device memory;
17. the explicit solver: the regression (q=10, d=5) and power families of
   tests/test_explicit.py through generate_code(solver='explicit'),
   solve(method='CPG') (first call and the mean of five more) within 1e-4
   of the oracle, and explicit_evaluate at B=16384 parameter points drawn
   over the domain box: its time (CUDA events), x within 1e-4 of the
   oracle on 64 and within 1e-5 of the CPU evaluator on all, and a
   chunked evaluation within 1e-5 of the whole;
18. runtime/profiling.py's stage split (canonicalize, equilibrate, KKT
   assembly, the Newton-Schulz factor, one check interval of K3, the whole
   solve; CUDA events) of MPC per-instance at B=2048 on the K3 route
   (phase 6's settings, 12 warm sweeps), and the device's busy share of
   that solve from a trace (runtime/profiling.py::trace; the trace must
   show device time and K3's kernel);
19. the parallel layer on a 2-rank gloo world, both ranks on cuda:0 (NCCL
   refuses two ranks on one card): sharded_solve of the shared MPC batch
   (B=2048, the bench's settings: K1 on each rank at the whole batch's rho
   group, 1024), of the K3 route (phase 6's batch, and 12 instances a
   rank: the whole batch of 24 has the reference's block 8, a rank alone
   none, so each rank must launch K3 and be bitwise one process at B=24)
   and of the K2 route
   (the general row's settings, B=256: K2 on each rank at the whole
   batch's block, 8), each against rank 0's single-process solve (equal
   status and iterations, x within SHARD_TOL; bitwise equality printed);
   the scenario consensus of tests/test_consensus.py's family at B=2048
   (K1 inside; equal outer iterations, zbar within CONSENSUS_TOL of one
   process) and at B=16, whose rho group of 16 no rank of 8 can hold (it
   must raise); make_sharded_qp_solve on a 1 x 2 ('batch', 'model') mesh
   at B=64 against the replicated torch loop (equal status and
   iterations, x within SHARD_TOL); K1's, K2's and K3's launches of the
   sharded runs join the kernels line;
20. the per-instance MPC solve (K3 route, B=256) exported by
   runtime/aot.py, loaded and run in a fresh process that builds no
   Family (``--run-exported``), against the live solve (equal status and
   iterations, x within SHARD_TOL), with both times and the exported
   program's K3 launches (added to the kernels line);
21. the embedded-C artifact (native/, codegen/emit_c.py): MPC H=10
   through generate_code(gradient=True) at the default device, its
   LICENSE equal to the repository's, its README.html naming the
   parameters, the variables and c/cpg_core.cpp; the ctypes library
   (native.get_lib) and the c/ projects of MPC and of charging T=1440
   (tests/test_admm_banded.py's family: the sparse COO + RCM-banded
   emission) built at once (``make``, which must be on PATH); MPC's
   ./cpg_example at status 1, its objective
   within 1e-2 of solve(method='CPG') on the card and of the float64
   oracle, its dobj/dtheta entries within 1e-6 of
   NativeQPSolver.gradient(gobj=1.0); phase 3's shared batch (B=2048,
   K1) against NativeQPSolver at eps 1e-6 on 64 instances within 1e-2;
   charging's ./cpg_example at status 1 within 1e-2 of
   CompiledBandedQPSolver (K4) at eps 1e-4 on the card; the builds', the
   examples' and the host solves' times beside the host CPU's model;
   K1's and K4's launches join the kernels line;
22. float64 on the card through the default routes (the kernels take
   float32; B=64 each, eps 1e-6): MPC H=10 through generate_code(dtype=
   'float64') -> solve_batch on the shared torch loop, one
   solve(method='CPG'), the per-instance loop (K3's float32 route takes
   this B), ADP and entropy n=32 on the IPM at kkt_solver 'auto' ('lu');
   each within the port's CPU float64 tests' bar of the float64 oracle
   (entropy: logsumexp(c) and softmax(c)) and against the port's CPU
   float64 run of the same route (statuses equal, iterations within one
   check interval, x within 1e-6); MPC H=30 through
   CompiledBandedQPSolver at B=2 on the per-instance banded engine (the
   shared one in float32), held the same way (the banded tests' 1e-3 of
   the oracle); no kernel launched; the banded shared engine on charging
   T=1440 in float64 raises its ValueError at entry, and
   CompiledBandedQPSolver routes that batch to the per-instance engine;
   each route timed after its first call, beside the card;
23. a JSON line with each kernel's launches, error, times and bound;
24. the card's name and power limit (nvidia-smi), then the result line.

``python3 chip_smoke.py --block-sweep`` instead builds the kernels and runs
K2 on the portfolio and MPC general batches at several blocks, printing
instances solved, mean iterations and time per block.
``python3 chip_smoke.py --nccl`` builds the kernels and runs phase 19 over
every card of the host, one NCCL rank per card (1024 instances a rank).

It needs a CUDA device and the repository beside it: without either it
exits non-zero and prints no result.
"""
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py:142-152, the shared MPC row
BENCH_SETTINGS = dict(
    eps_abs=1e-3, eps_rel=1e-3, max_iter=2000, check_interval=15,
    ns_iters=16, ns_f32_iters=6, ns_adapt_iters=12, adaptive_rho_until=0,
    scaling=3, use_pallas='auto', kkt_refine=1, adaptive_rho=True)
# bench.py:312-314, the general (per-instance) MPC row; the other fields
# keep their defaults (ns_iters 16, ns_f32_iters 5, kkt_refine 1)
GENERAL_SETTINGS = dict(
    eps_abs=1e-3, eps_rel=1e-3, max_iter=2000, check_interval=15,
    adaptive_rho=True, scaling=3, use_pallas='full', ns_adapt_iters=6)
# bench.py:493-495, the portfolio row with per-instance factor loadings
PORTFOLIO_SETTINGS = dict(
    eps_abs=3e-4, eps_rel=3e-4, max_iter=4000, check_interval=15,
    adaptive_rho=True, use_pallas='full')
# the same with a second refinement sweep: with one, whether a few borderline
# instances of this family reach eps 3e-4 within max_iter is decided by
# float32 roundoff (PERF.md, Findings), with two every instance does
PORTFOLIO_SETTINGS_REFINE2 = dict(PORTFOLIO_SETTINGS, kkt_refine=2)
# the share of portfolio instances that may stay unsolved at the bench's
# one refinement sweep (the 1% of phase 2's bar)
PORTFOLIO_UNSOLVED_SHARE = 0.01
# bench.py:544-580, the charging row (reference examples/charging.ipynb) on
# the banded engine
CHARGING_T = 1440
CHARGING_SETTINGS = dict(eps_abs=1e-3, eps_rel=1e-3, max_iter=10000,
                         check_interval=50, adaptive_rho=True)
# bench.py:142-152, the fields of the shared MPC row that the banded engine
# reads (the Newton-Schulz fields have no counterpart there)
MPC30_SETTINGS = dict(eps_abs=1e-3, eps_rel=1e-3, max_iter=2000,
                      check_interval=15, scaling=3, adaptive_rho=True)
# float64 references on the card for the charging parity bars: the dense
# ADMM loops in float64 at eps 1e-6 (the NumPy oracle is impractical at
# n + m = 14405)
DENSE_REF_SETTINGS = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000,
                          check_interval=25, adaptive_rho=True,
                          kkt_solver='inv', use_pallas='never')
# at the bench's eps 1e-3 the ADMM stopping rule alone leaves charging
# objectives up to about 1% from the optimum (the dense float64 ADMM at
# eps 1e-3 shows the same gap, PERF.md): the bench-setting batch is held to
# that float64 run, and the 1e-2 bar against eps 1e-6 is held at
# CHARGING_TIGHT_EPS
CHARGING_TIGHT_EPS = 1e-4
B_CHARGING = 256
B_CHARGING_PER = 64
N_REF_CHARGING = 8
N_REF_CHARGING_PER = 4
N_ORACLE_MPC30 = 16
# K4 against its plain version: per instance, max |dx| <= K4_TOL * max(1,
# |x|_inf).  Both apply the same float32 factor; their dot products sum in
# other orders, and each CR level carries that roundoff into the next, so
# the bar is the float32 roundoff (~1e-7) times the growth through the
# levels; the script prints the plain version's own distance from a
# float64 application of the same factor beside it.  A random b would give
# an x whose few huge entries (M's small eigenvalues) set the bar and hide
# the others, so the random case solves for a known x ~ N(0, 1)
K4_TOL = 1e-4
# the batches K4 is held at: one instance, a partial group, the main batch
# and 2048
K4_BATCHES = (1, 3, B_CHARGING, 2048)
# K5 against its plain version: x, z, y within K5_TOL * max(1, |v|_inf)
# per instance; rp and rp_den within K5_TOL * max(1, rp_den), rd and rd_den
# within K5_TOL * max(1, rd_den) (a residual is the norm of a difference of
# terms of the size of its denominator, and inherits their roundoff); equal
# flags;
# where the ok flag differs, the residual must lie within K5_FLAG_BAND
# (relative to max(1, threshold)) of its threshold
K5_TOL = 1e-4
K5_FLAG_BAND = 1e-5
B_MAIN = 2048
B_CMP = 256
# a per-instance batch that the reference's block rule gives no block (B
# not a multiple of 8): the K3 route's 'auto' runs the refined loop there
B_SMALL_ROUTE = 6
# K1 also at pinned chunks: 8, the rho group of the port's first rule, and
# 4, 2, 1, whose thread blocks hold 4, 2 and 1 instances
K1_PINNED_CHUNKS = (8, 4, 2, 1)
B_PORTFOLIO = 512
B_K3_SLICE = 512
N_ORACLE = 128
N_ORACLE_PORTFOLIO = 16
PARITY_BAR = 1e-2
# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3 rate
FP32_PEAK = 67e12
HBM_RATE = 3.35e12
# the same: dense TF32 on the tensor cores; K2's factorization takes three
# TF32 passes per product, so its second yardstick divides this by 3
TF32_PEAK = 495e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def mpc_problem(ct, H=10, n=6, m=3):
    """The MPC family of tests/problems.py:65-101 (reference
    tests/test_E2E_QP.py:43-73) in the port's modeling layer."""
    U = ct.Variable((m, H), name='U')
    X = ct.Variable((n, H + 1), name='X')
    Psqrt = ct.Parameter((n, n), name='Psqrt', diag=True)
    Qsqrt = ct.Parameter((n, n), name='Qsqrt', diag=True)
    Rsqrt = ct.Parameter((m, m), name='Rsqrt', diag=True)
    nonzeros_A = [(i, i) for i in range(n)] + [(i, 3 + i) for i in range(n // 2)]
    A = ct.Parameter((n, n), name='A', sparsity=tuple(zip(*nonzeros_A)))
    nonzeros_B = [(3 + i, i) for i in range(n // 2)]
    B = ct.Parameter((n, m), name='B', sparsity=tuple(zip(*nonzeros_B)))
    x_init = ct.Parameter(n, name='x_init')
    objective = ct.Minimize(
        ct.sum_squares(Psqrt @ X[:, H - 1]) + ct.sum_squares(Qsqrt @ X[:, :H])
        + ct.sum_squares(Rsqrt @ U) + 1)
    constraints = [X[:, 1:] == A @ X[:, :H] + B @ U,
                   ct.abs(U) <= 1,
                   X[:, 0] == x_init]
    return ct.Problem(objective, constraints)


def assign_mpc(prob, seed=0):
    np.random.seed(seed)
    n = 6
    A_cont = np.concatenate((np.array([[0, 0, 0, 1, 0, 0],
                                       [0, 0, 0, 0, 1, 0],
                                       [0, 0, 0, 0, 0, 1.]]),
                             np.zeros((3, 6))), axis=0)
    B_cont = np.concatenate((np.zeros((3, 3)), np.diag(np.ones(3))), axis=0)
    td = 0.1
    prob.param_dict['A'].value = np.eye(n) + td * A_cont
    prob.param_dict['B'].value = td * B_cont
    prob.param_dict['Psqrt'].value = np.eye(6)
    prob.param_dict['Qsqrt'].value = np.eye(6)
    prob.param_dict['Rsqrt'].value = np.sqrt(0.1) * np.eye(3)
    prob.param_dict['x_init'].value = -2 * np.ones(6) + 4 * np.random.rand(6)
    return prob


def x_init_batch(fam, prob, B, seed=0):
    """B distinct instances: same dynamics and weights, x_init drawn as in
    bench.py:132-136."""
    base = fam.pack_theta(params=prob.parameters())
    xi = [pi for pi in fam.param_info if pi.name == 'x_init'][0]
    theta = np.tile(base, (B, 1))
    theta[:, xi.offset:xi.offset + xi.flat_size] = np.random.default_rng(
        seed).uniform(-2.0, 2.0, (B, xi.flat_size))
    return theta


def card_line():
    res = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f'nvidia-smi failed: {res.stderr}')
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def k1_bound(n, m, B, iters, refactors, st):
    """Least time of K1's work on these inputs: the larger of the FP32
    operations over the FP32 peak and the bytes over the HBM rate."""
    it = float(np.sum(iters))
    per_iter = 2.0 * (2 * m * n + (1 + 2 * st.kkt_refine) * n * n)
    per_check = 2.0 * (4 * m * n + 2 * n * n)
    per_refactor = 2.0 * (n * n * m + n ** 3 + st.ns_adapt_iters * 2 * n ** 3)
    ops = (it * per_iter + it / st.check_interval * per_check
           + refactors * per_refactor)
    words = (3 * n * n + 2 * m * n + 2 * m + n          # shared inputs
             + B * (2 * n + 4 * m)                      # q, x0, l, u, z0, y0
             + B * (n + 2 * m + 4))                     # x, z, y, 4 scalars
    t_ops, t_bytes = ops / FP32_PEAK, 4.0 * words / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops)


def phase_build():
    """Build K1-K11 at once: one nvcc per source, in parallel."""
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    from cvxpygen_tpu_torch.ops import banded_shared_kernel as k45
    from cvxpygen_tpu_torch.ops import ldl_kernel as k678
    t0 = time.perf_counter()
    srcs = (('admm_shared.cu', k1.build_kernel),
            ('admm_full.cu', k2.build_kernel),
            ('admm_iterate.cu', k3.build_kernel),
            ('cr_solve.cu', k45.build_cr_kernel),
            ('banded_chunk.cu', k45.build_chunk_kernel),
            ('ldl_factor.cu', k678.build_factor_kernel),
            ('ldl_inverse.cu', k678.build_inverse_kernel),
            ('ldl_solve.cu', k678.build_solve_kernel),
            ('ldl_kinv.cu', k678.build_kinv_kernel),
            ('banded_iterate.cu', k45.build_iterate_kernel))
    with ThreadPoolExecutor(len(srcs)) as ex:
        futs = [(src, ex.submit(build, True)) for src, build in srcs]
        for src, fut in futs:
            print(f'# phase 1: built csrc/{src} in {fut.result():.2f} s')
    print(f'# phase 1: all builds {time.perf_counter() - t0:.2f} s')
    card = card_line()
    print(f'# card: {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}; allow_tf32 matmul='
          f'{torch.backends.cuda.matmul.allow_tf32} cudnn='
          f'{torch.backends.cudnn.allow_tf32}')
    return card


def k1_inputs(fam, theta, st, dev):
    from cvxpygen_tpu_torch.runtime.torch_family import (
        TorchFamily, canon_batch_shared, qp_bounds_batch)
    from cvxpygen_tpu_torch.solvers.admm_shared import shared_kernel_args
    tf = TorchFamily.from_family(fam, device=dev)
    data = canon_batch_shared(tf, theta)
    l, u = qp_bounds_batch(tf, data['b'])
    return shared_kernel_args(data['P'], data['q'], data['A'], l, u,
                              tf.n_zero, st)


def compare_k1(fam, prob, B, st, card, timed, chunk=None):
    """K1 and its plain version on the same scaled MPC data, at ``chunk``
    (default: the rule's rho group); returns the error and, when ``timed``,
    the times and the bound."""
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    from cvxpygen_tpu_torch.solvers.admm_shared import kernel_kwargs
    args = k1_inputs(fam, x_init_batch(fam, prob, B), st, 'cuda')
    if chunk is None:
        chunk = k1.pick_shared_chunk(B, fam.m, fam.n)
    kw = dict(kernel_kwargs(st), chunk=chunk)
    stats = {}
    with full_f32_matmul():
        ref = k1.admm_shared_solve_plain(*args, **kw, stats=stats)
    torch.cuda.synchronize()
    out = k1.admm_shared_solve(*args, **kw)
    torch.cuda.synchronize()
    max_abs = k1_errors(out, ref, args, B, chunk, st, stats, 'default')
    # the order-fixed chunk reductions: a second call gives the same bits
    again = k1.admm_shared_solve(*args, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f'B={B} chunk={chunk}: two calls of K1 on one input differ')
    print(f'# phase 2: B={B} chunk={chunk}: a second call is bitwise equal')
    if not timed:
        return dict(max_abs_err=max_abs)
    it_ref = ref[3]
    # instances per thread block are the card's choice, not part of the
    # answer: 8 per block (the private hook) gives the bits of the default 16
    res = k1._launch(args, kw, 8)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(out, res)),
          f'B={B}: K1 at 8 instances per block differs from the default')
    print(f'# phase 2: B={B} chunk={chunk}: 8 instances per block give the '
          'bits of the default 16')
    k1.admm_shared_solve(*args, **kw)            # warm
    ms, _ = cuda_ms(lambda: k1.admm_shared_solve(*args, **kw), 3)
    launches = k1.admm_shared_solve.device_launches
    with full_f32_matmul():
        plain_ms, _ = cuda_ms(
            lambda: k1.admm_shared_solve_plain(*args, **kw), 1)
    bound_ms, bound_by, ops = k1_bound(fam.n, fam.m, B, it_ref.cpu().numpy(),
                                       stats['refactors'], st)
    print(f'# phase 2: K1 at B={B} chunk={chunk}: kernel {ms:.3f} ms '
          f'({launches} device launches per call), plain {plain_ms:.3f} ms, '
          f'bound {bound_ms:.4f} ms ({bound_by}; {ops / 1e9:.2f} GFLOP FP32; '
          f'{stats["refactors"]} chunk refactorizations) [{card}]')
    # where K1's time goes: the same batch without adaptive rho (no
    # refactorization), and two check intervals without and with a forced
    # refactorization of every chunk between them (rho_tol just above 1; a
    # chunk that stops does not refactor)
    probes = [('adaptive rho off', dict(kw, adaptive=False)),
              ('two checks, no refactor',
               dict(kw, max_iter=2 * st.check_interval, adaptive=False)),
              ('two checks + one refactor per chunk',
               dict(kw, max_iter=2 * st.check_interval,
                    rho_tol=1.0 + 1e-6))]
    for name, pkw in probes:
        res = k1.admm_shared_solve(*args, **pkw)
        p_ms, _ = cuda_ms(lambda: k1.admm_shared_solve(*args, **pkw), 3)
        print(f'# phase 2: K1 probe, {name}: {p_ms:.3f} ms, '
              f'{k1.admm_shared_solve.device_launches} device launches, mean '
              f'iters {float(res[3].float().mean()):.2f} [{card}]')
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def k1_errors(out, ref, args, B, chunk, st, stats, label):
    """Hold K1's result against the plain version's: equal status,
    iterations within one check interval, x within 1e-3 * max(1, |x|) where
    the iterations agree, at most 1% of the instances one check apart with
    objectives within the parity bar.  Returns max |dx|."""
    x, it, status = out[0], out[3], out[4]
    x_ref, it_ref, status_ref = ref[0], ref[3], ref[4]
    check(bool(torch.isfinite(x).all()), f'B={B}: non-finite kernel x')
    check(torch.equal(status, status_ref),
          f'B={B} {label}: kernel status differs from the plain version on '
          f'{int((status != status_ref).sum())} instances')
    d_it = int((it - it_ref).abs().max())
    check(d_it <= st.check_interval,
          f'B={B} {label}: iterations differ by {d_it} > '
          f'{st.check_interval}')
    # x is held at 1e-3 where both stopped at the same iteration.  Where
    # summation order moved a convergence check by one interval, the two
    # are converged iterates check_interval iterations apart: those must be
    # rare and agree in objective at the oracle parity bar instead.
    same = it == it_ref
    err = (x - x_ref).abs()[same]
    viol = float((err / torch.clamp(x_ref[same].abs(), min=1.0)).max())
    max_abs = float(err.max())
    check(viol <= 1e-3, f'B={B} {label}: max |dx| / max(1, |x|) = '
          f'{viol:.3e} > 1e-3')
    n_diff = int((~same).sum())
    check(n_diff <= B // 100, f'B={B} {label}: {n_diff} instances stop at '
          'another iteration')
    obj_rel = 0.0
    if n_diff:
        Ps, qs, c_inv = args[0], args[1], args[8]

        def obj(xs):
            return c_inv * (0.5 * ((xs @ Ps) * xs).sum(1)
                            + (qs[~same] * xs).sum(1))
        o, o_ref = obj(x[~same]), obj(x_ref[~same])
        obj_rel = float(((o - o_ref).abs()
                         / torch.clamp(o_ref.abs(), min=1.0)).max())
        check(obj_rel <= PARITY_BAR, f'B={B} {label}: objective differs by '
              f'{obj_rel}')
    itf = it.float()
    print(f'# phase 2: B={B} chunk={chunk} {label}: status equal, max |d '
          f'iters| {d_it}, mean iters {float(itf.mean()):.2f} (plain '
          f'{float(it_ref.float().mean()):.2f}), max iters {int(it.max())}, '
          f'solved {int((status == 1).sum())}; same iterations: max |dx| '
          f'{max_abs:.3e} (max |dx|/max(1,|x|) {viol:.3e}); {n_diff} '
          f'instances one check apart, objective rel {obj_rel:.2e}; plain '
          f'refactorizations {stats["refactors"]}')
    return max_abs


def phase_kernels(card):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    prob = assign_mpc(mpc_problem(ct))
    fam = canonicalize(prob)
    check((fam.n, fam.m) == (222, 252), f'MPC shape {fam.n}, {fam.m}')
    st = ADMMSettings(**BENCH_SETTINGS)
    compare_k1(fam, prob, B_CMP, st, card, timed=False)
    for chunk in K1_PINNED_CHUNKS:
        compare_k1(fam, prob, B_CMP, st, card, timed=False, chunk=chunk)
    return compare_k1(fam, prob, B_MAIN, st, card, timed=True)


def phase_main_path(card, k1_ms):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch import cpg
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings

    k1.admm_shared_solve.launches = 0
    # generated package, one instance through problem.solve(method='CPG')
    prob = assign_mpc(mpc_problem(ct))
    val_oracle = prob.solve()
    code_dir = os.path.join(ROOT, 'build', 'chip_smoke', 'mpc_code')
    cpg.generate_code(prob, code_dir=code_dir, solver='ADMM')
    t0 = time.perf_counter()
    val = prob.solve(method='CPG')
    t_cpg = time.perf_counter() - t0
    rel = abs(val - val_oracle) / max(1.0, abs(val_oracle))
    check(prob.status == 'optimal', f'CPG status {prob.status}')
    check(rel <= PARITY_BAR, f'CPG objective {val} vs oracle {val_oracle}')
    # one instance has no rho group (pick_shared_chunk gives None, as in the
    # JAX package): the solver's torch loop, not K1
    fam = canonicalize(prob)
    check(k1.pick_shared_chunk(1, fam.m, fam.n) is None
          and k1.admm_shared_solve.launches == 0, 'the B=1 solve launched K1')
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        prob.solve(method='CPG')
    t_steady = (time.perf_counter() - t0) / reps
    print(f'# phase 3: solve(method=CPG) optimal, objective {val:.6f} vs '
          f'oracle {val_oracle:.6f} (rel {rel:.2e}), '
          f'{prob.solver_stats.num_iters} iters, no rho group (the torch '
          f'loop, K1 launches '
          f'{k1.admm_shared_solve.launches}): {1e3 * t_cpg:.2f} ms first '
          f'call, {1e3 * t_steady:.2f} ms mean of the next {reps} [{card}]')

    # B distinct x_init instances through the compiled solver
    theta = x_init_batch(fam, prob, B_MAIN)
    solver = CompiledQPSolver(fam, settings=ADMMSettings(**BENCH_SETTINGS))
    check(solver.jf.maps.dtype == torch.float32, 'float32 on the card')
    out = solver.solve_batch(theta)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solver.solve_batch(theta)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    launches = k1.admm_shared_solve.launches
    check(launches > 0, 'the main path did not launch kernel K1')
    status = out['status'].cpu().numpy()
    frac = float(np.mean(status == 1))
    obj = (out['obj'] + out['d']).double().cpu().numpy()
    check(bool(np.all(np.isfinite(out['x'].cpu().numpy()))), 'non-finite x')
    t0 = time.perf_counter()
    refs = oracle_objs(fam, theta, N_ORACLE)
    t_oracle = time.perf_counter() - t0
    max_rel, n_bad = parity(obj, refs)
    iters = out['iters'].float()
    print(f'# phase 3: solve_batch B={B_MAIN} (rho group '
          f'{k1.pick_shared_chunk(B_MAIN, fam.m, fam.n)}): frac_solved {frac}, '
          f'mean iters {float(iters.mean()):.2f} (max {int(iters.max())}), '
          f'{B_MAIN / dt:.1f} solves/s, {1e3 * dt:.3f} ms per batch (K1 '
          f'{k1_ms:.3f} ms of it, phase 2), K1 launches {launches} [{card}]')
    print(f'# phase 3: oracle parity on {N_ORACLE} instances: max rel '
          f'{max_rel:.3e} ({n_bad} non-finite; oracle {t_oracle:.1f} s)')
    check(frac == 1.0, f'frac_solved {frac} < 1')
    check(n_bad == 0 and max_rel <= PARITY_BAR,
          f'oracle parity {max_rel:.3e} ({n_bad} non-finite) > {PARITY_BAR}')
    return launches, refs


def oracle_objs(fam, theta, k):
    """The float64 oracle's objectives (canonical objective plus the
    constant d) of the first k rows of theta."""
    from cvxpygen_tpu_torch.solvers.oracle import solve_family_numpy
    refs = []
    for i in range(k):
        res, _ = solve_family_numpy(fam, theta[i])
        refs.append(res.obj + fam.canon_numpy(theta[i])[2])
    return refs


def parity(obj, refs):
    """Largest relative objective error max |o - r| / max(1, |r|) over the
    oracle's rows, and the number of non-finite objectives among them."""
    max_rel, n_bad = 0.0, 0
    for o, r in zip(obj, refs):
        if not math.isfinite(o):
            n_bad += 1
            continue
        max_rel = max(max_rel, abs(o - r) / max(1.0, abs(r)))
    return max_rel, n_bad


def per_instance_inputs(fam, prob, B, st, theta=None):
    """The scaled per-instance data that admm_solve hands to K2 for theta,
    by default B distinct MPC instances (canonical P and A per row)."""
    from cvxpygen_tpu_torch.runtime.torch_family import (
        TorchFamily, canon_batch, qp_bounds_batch)
    from cvxpygen_tpu_torch.solvers.admm import full_kernel_args
    tf = TorchFamily.from_family(fam, device='cuda')
    if theta is None:
        theta = x_init_batch(fam, prob, B)
    data = canon_batch(tf, theta)
    l, u = qp_bounds_batch(tf, data['b'])
    return full_kernel_args(data['P'], data['q'], data['A'], l, u,
                            tf.n_zero, st)


def k3_inputs(args, st):
    """K3's inputs on the scaled data: M^-1 from the cold Newton-Schulz
    start that the K3 route computes (16 sweeps in torch.matmul)."""
    from cvxpygen_tpu_torch.solvers.admm import (full_f32_matmul,
                                                 newton_schulz_inverse)
    Ps, qs, As, ls, us, rho, _, _, _, x0, z0, y0 = args
    n = Ps.shape[-1]
    with full_f32_matmul():
        M = (Ps + st.sigma * torch.eye(n, device=Ps.device)) + torch.matmul(
            As.transpose(1, 2), As * rho[:, :, None])
        Minv = newton_schulz_inverse(M, st.ns_iters)
    return [Minv, As, qs, ls, us, rho, x0, z0, y0]


def well_conditioned_iterate_inputs(n, m, B, sigma, seed=5):
    """K3's inputs for a batch of well-conditioned QPs of shape (n, m),
    drawn from ``seed``: P = G G' / n + I, A ~ N(0, 1 / n), rho in
    [0.1, 1], M^-1 the float64 inverse of P + sigma I + A' diag(rho) A (its
    condition number about 4), box bounds around 0, a zero start."""
    g = np.random.default_rng(seed)
    G = g.standard_normal((B, n, n)) / np.sqrt(n)
    A = g.standard_normal((B, m, n)) / np.sqrt(n)
    rho = g.uniform(0.1, 1.0, (B, m))
    M = (G @ G.transpose(0, 2, 1) / n + (1.0 + sigma) * np.eye(n)
         + A.transpose(0, 2, 1) @ (A * rho[:, :, None]))
    q = g.standard_normal((B, n))
    l = -1.0 - g.uniform(0.0, 1.0, (B, m))
    u = 1.0 + g.uniform(0.0, 1.0, (B, m))
    t = [torch.tensor(v, dtype=torch.float32, device='cuda')
         for v in (np.linalg.inv(M), A, q, l, u, rho)]
    zeros = [torch.zeros((B, d), device='cuda') for d in (n, m, m)]
    return t + zeros


def k3_bound(n, m, B, n_iters):
    """Least time of K3's work: the larger of the FP32 operations over the
    FP32 peak and the bytes (each input read once, each output written
    once) over the HBM rate."""
    ops = 2.0 * B * n_iters * (2 * m * n + n * n)
    nbytes = 4.0 * B * (n * n + m * n + 3 * n + 7 * m)
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops, nbytes)


def k3_viol(out, ref):
    """Per (x, z, y): the largest absolute difference and the largest
    per-instance max |d| / max(1, |v|_inf)."""
    res = []
    for o, r in zip(out, ref):
        err = (o - r).abs()
        scale = torch.clamp(r.abs().amax(dim=1, keepdim=True), min=1.0)
        res.append((float(err.max()), float((err / scale).max())))
    return res


def k3_errors(out, ref, label, bar=1e-4):
    """Hold K3's (x, z, y) against the plain version's: per instance within
    bar * max(1, |v|_inf).  Returns the largest absolute difference."""
    max_abs = 0.0
    for name, o, (err, viol) in zip('xzy', out, k3_viol(out, ref)):
        check(bool(torch.isfinite(o).all()), f'K3 {label}: non-finite {name}')
        max_abs = max(max_abs, err)
        print(f'# phase 4: K3 {label}, {name}: max |d| {err:.3e}, max |d| / '
              f'max(1, |{name}|_inf) {viol:.3e} (bar {bar:.3e})')
        check(viol <= bar, f'K3 {label} {name}: {viol:.3e} > {bar:.3e}')
    return max_abs


def compare_k3(fam, prob, st, card, portfolio):
    """K3 against its plain version at B=256 from a zero start and from a
    mid-solve state (the resident layout, c = 2, and the streaming layout
    at two instances per block), on the portfolio batch (c = 1), then K3's
    time at B=2048, where the timed call is held against the plain version
    too."""
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings, full_f32_matmul
    n_it = st.check_interval
    ctas = k3.pick_iterate_ctas(fam.m, fam.n)
    print(f'# phase 4: K3 layout at n={fam.n}, m={fam.m}: c = {ctas} thread '
          f'blocks per instance ({k3.iterate_smem_bytes(fam.n, fam.m, ctas)}'
          ' bytes of shared memory each)')
    check(ctas == 2, f'K3 at the MPC shape: c = {ctas}, 2 expected')
    args = k3_inputs(per_instance_inputs(fam, prob, B_CMP, st), st)
    with full_f32_matmul():
        mid = k3.admm_iterate_plain(*args, st.sigma, st.alpha, 3 * n_it)
    max_abs = 0.0
    for start, state in (('zero start', args[6:]), ('mid-solve', mid)):
        a = args[:6] + list(state)
        with full_f32_matmul():
            ref = k3.admm_iterate_plain(*a, st.sigma, st.alpha, n_it)
        for block, layout in ((None, f'resident c={ctas}'),
                              (2, 'streaming, 2 per block')):
            out = k3.admm_iterate(*a, st.sigma, st.alpha, n_it, block=block)
            torch.cuda.synchronize()
            max_abs = max(max_abs, k3_errors(
                out, ref, f'B={B_CMP} {start} ({layout})'))
    pfam, ptheta, _ = portfolio
    pst = ADMMSettings(**PORTFOLIO_SETTINGS)
    pctas = k3.pick_iterate_ctas(pfam.m, pfam.n)
    check(pctas == 1, f'K3 at the portfolio shape: c = {pctas}, 1 expected')
    # the portfolio shape (c = 1) on a well-conditioned batch, at 1e-4
    wargs = well_conditioned_iterate_inputs(pfam.n, pfam.m, B_PORTFOLIO,
                                            pst.sigma)
    with full_f32_matmul():
        ref = k3.admm_iterate_plain(*wargs, pst.sigma, pst.alpha, n_it)
    for block, layout in ((None, f'resident c={pctas}'),
                          (2, 'streaming, 2 per block')):
        out = k3.admm_iterate(*wargs, pst.sigma, pst.alpha, n_it,
                              block=block)
        torch.cuda.synchronize()
        max_abs = max(max_abs, k3_errors(
            out, ref, f'well-conditioned n={pfam.n}, m={pfam.m}, '
            f'B={B_PORTFOLIO} ({layout})'))
    pargs = k3_inputs(per_instance_inputs(pfam, None, B_PORTFOLIO, pst,
                                          theta=ptheta), pst)
    # this family is ill-conditioned (phase 5): the bar is twice the spread
    # that one ulp of q gives the plain version, and at least 1e-4
    ulp = list(pargs)
    ulp[2] = pargs[2] * (1.0 + 2.0 ** -23)
    with full_f32_matmul():
        ref = k3.admm_iterate_plain(*pargs, pst.sigma, pst.alpha, n_it)
        ref_ulp = k3.admm_iterate_plain(*ulp, pst.sigma, pst.alpha, n_it)
    pbar = max(1e-4, 2 * max(v for _, v in k3_viol(ref_ulp, ref)))
    for block, layout in ((None, f'resident c={pctas}'),
                          (2, 'streaming, 2 per block')):
        out = k3.admm_iterate(*pargs, pst.sigma, pst.alpha, n_it,
                              block=block)
        torch.cuda.synchronize()
        max_abs = max(max_abs, k3_errors(
            out, ref, f'portfolio B={B_PORTFOLIO} zero start ({layout})',
            bar=pbar))
    args = k3_inputs(per_instance_inputs(fam, prob, B_MAIN, st), st)
    k3.admm_iterate(*args, st.sigma, st.alpha, n_it)          # warm
    ms, out = cuda_ms(lambda: k3.admm_iterate(*args, st.sigma, st.alpha,
                                                n_it), 5)
    with full_f32_matmul():
        plain_ms, ref = cuda_ms(lambda: k3.admm_iterate_plain(
            *args, st.sigma, st.alpha, n_it), 1)
    max_abs = max(max_abs, k3_errors(out, ref, f'B={B_MAIN} zero start'))
    bound_ms, bound_by, ops, nbytes = k3_bound(fam.n, fam.m, B_MAIN, n_it)
    print(f'# phase 4: K3 at B={B_MAIN}, {n_it} iterations (resident, c='
          f'{ctas}): kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound '
          f'{bound_ms:.4f} ms ({bound_by}; {ops / 1e9:.2f} GFLOP FP32, '
          f'{nbytes / 1e9:.3f} GB) [{card}]')
    # where K3's time goes: the copy of the rows into shared memory alone
    copy_ms = cuda_ms(lambda: k3.admm_iterate(*args, st.sigma, st.alpha, 0),
                      5)[0]
    print(f'# phase 4: K3 probe, 0 iterations (the rows copied in, the '
          f'vectors out): {copy_ms:.3f} ms [{card}]')
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def k2_bound(n, m, B, iters, stats, st, block):
    """Least time of K2's work on these inputs: the larger of the FP32
    operations over the FP32 peak and the bytes over the HBM rate.  The
    refactorizations and rescues are those of the plain version's run on
    the same inputs."""
    it = float(np.sum(iters))
    n3 = float(n) ** 3
    cold = B * (n * n * m + st.ns_iters * 2 * n3
                + (n3 if st.ns_iters > st.ns_f32_iters else 0))
    per_iter = 2 * m * n + (1 + 2 * st.kkt_refine) * n * n
    per_check = 2 * (2 * m * n + n * n)
    refactor = stats['refactor_blocks'] * block * (
        n * n * m + n3 + st.ns_adapt_iters * 2 * n3 + n3)
    rescue = stats['rescue_blocks'] * block * max(st.ns_iters, 30) * 2 * n3
    ops = 2.0 * (cold + it * per_iter + it / st.check_interval * per_check
                 + refactor + rescue)
    nbytes = 4.0 * B * (n * n + m * n + 3 * n + 5 * m + 1   # inputs
                        + n + 2 * m + 5)                    # outputs
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops,
            2.0 * (cold + refactor + rescue))


def k2_errors(out, ref, B, block, st, label, one_check=True,
              unsettled=None):
    """Hold K2's result against the plain version's, the bar of phase 2:
    equal status, x within 1e-3 * max(1, |x|) where the iterations agree,
    at most 1% of instances at other iterations, with objectives within
    1e-2, and with ``one_check`` those one check interval apart at most.
    ``unsettled`` (a mask) marks the instances on which the plain version
    disagrees with itself beyond that x bar; they are held as instances at
    other iterations are (counted in the 1%, objectives within 1e-2).
    Returns the largest absolute difference of x where the iterations
    agree and the instance is settled."""
    x, obj, it, status = out[0], out[3], out[4], out[5]
    x_ref, obj_ref, it_ref, status_ref = ref[0], ref[3], ref[4], ref[5]
    check(bool(torch.isfinite(x).all()), f'K2 {label}: non-finite x')
    check(torch.equal(status, status_ref),
          f'K2 {label}: status differs on '
          f'{int((status != status_ref).sum())} instances')
    d_it = int((it - it_ref).abs().max())
    print(f'# phase 5: K2 {label}, B={B}: {int((it != it_ref).sum())} '
          f'instances at other iterations, at most {d_it} apart')
    if one_check:
        check(d_it <= st.check_interval, f'K2 {label}: iterations differ '
              f'by {d_it} > {st.check_interval}')
    same = it == it_ref
    if unsettled is not None:
        same = same & ~unsettled
    err = (x - x_ref).abs()[same]
    viol = float((err / torch.clamp(x_ref[same].abs(), min=1.0)).max())
    check(viol <= 1e-3, f'K2 {label}: max |dx| / max(1, |x|) = {viol:.3e}')
    n_diff = int((~same).sum())
    check(n_diff <= B // 100, f'K2 {label}: {n_diff} instances stop at '
          'other iterations or are unsettled')
    obj_rel = 0.0
    if n_diff:
        o, o_ref = obj[~same], obj_ref[~same]
        obj_rel = float(((o - o_ref).abs()
                         / torch.clamp(o_ref.abs(), min=1.0)).max())
        check(obj_rel <= PARITY_BAR, f'K2 {label}: objective differs by '
              f'{obj_rel}')
    print(f'# phase 5: K2 {label}, B={B} block={block}: status equal, max '
          f'|d iters| {d_it}, mean iters {float(it.float().mean()):.2f} '
          f'(plain {float(it_ref.float().mean()):.2f}); same iterations'
          + ('' if unsettled is None else ', settled') + f': max |dx| '
          f'{float(err.max()):.3e} (max |dx|/max(1,|x|) {viol:.3e}); '
          f'{n_diff} instances at other iterations'
          + ('' if unsettled is None else ' or unsettled')
          + f', objective rel {obj_rel:.2e}')
    return float(err.max())


def compare_k2(fam, prob, st, card, portfolio):
    """K2 against its plain version on MPC at B=256 (the main path's block,
    one instance per block, and block 32: a cluster of 16 thread blocks of
    two instances each), then K2's time at B=2048 with probes of
    where it goes, the timed call held against the plain version too, and
    K2 against its plain version on the portfolio batch of phase 6."""
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.solvers.admm import (full_f32_matmul,
                                                 full_kernel_kwargs)
    kw = full_kernel_kwargs(st)
    main_block = k2.pick_full_block(B_MAIN, fam.m, fam.n)
    max_abs = 0.0
    for block in (main_block, 1, 16, 32):
        args = per_instance_inputs(fam, prob, B_CMP, st)
        out = k2.admm_solve_full(*args, **kw, block=block)
        torch.cuda.synchronize()
        with full_f32_matmul():
            ref = k2.admm_solve_full_plain(*args, **kw, block=block)
        ctas = k2.full_layout(block, fam.m, fam.n)
        print(f'# phase 5: K2 block {block} layout: ' + (
            f'resident, c = {ctas} thread blocks per instance' if ctas
            else 'streaming'))
        max_abs = max(max_abs, k2_errors(out, ref, B_CMP, block, st, 'MPC'))
    check(k2.full_layout(main_block, fam.m, fam.n) == 2,
          'K2 at the MPC main block: the resident layout with c = 2 expected')
    args = per_instance_inputs(fam, prob, B_MAIN, st)
    k2.admm_solve_full(*args, **kw, block=main_block)           # warm
    ms, out = cuda_ms(lambda: k2.admm_solve_full(*args, **kw,
                                                 block=main_block), 2)
    stats = {}
    with full_f32_matmul():
        plain_ms, ref = cuda_ms(lambda: k2.admm_solve_full_plain(
            *args, **kw, block=main_block, stats=stats), 1)
    # the plain version run block by block sees the kernel's batch size in
    # its batched products; every instance is held to it at 1e-3.  Against
    # the whole-batch run, the instances on which the two plain runs
    # disagree beyond 1e-3 count as unsettled (k2_errors)
    blk = k2_plain_by_block(k2, args, kw, main_block)
    max_abs = max(max_abs, k2_errors(out, blk, B_MAIN, main_block, st,
                                     'MPC (plain version block by block)',
                                     one_check=False))
    unsettled = plain_unsettled(blk, ref)
    print(f'# phase 5: K2 plain version block by block against the whole '
          f'batch, B={B_MAIN}: {int(unsettled.sum())} instances unsettled '
          f'(other iterations, or max |dx|/max(1,|x|) > 1e-3): '
          f'{torch.nonzero(unsettled).flatten().tolist()}')
    max_abs = max(max_abs, k2_errors(out, ref, B_MAIN, main_block, st,
                                     'MPC (plain version, whole batch)',
                                     one_check=False, unsettled=unsettled))
    bound_ms, bound_by, ops, factor_ops = k2_bound(
        fam.n, fam.m, B_MAIN, ref[4].cpu().numpy(), stats, st, main_block)
    print(f'# phase 5: K2 at B={B_MAIN}: kernel {ms:.3f} ms, plain '
          f'{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; '
          f'{ops / 1e9:.2f} GFLOP FP32); mean iters '
          f'{float(out[4].float().mean()):.2f}; plain refactorizations '
          f'{stats["refactor_blocks"]}, rescues {stats["rescue_blocks"]} '
          f'[{card}]')
    print(f'# phase 5: K2 second yardstick (not the bound): the '
          f'factorization\'s {factor_ops / 1e9:.2f} GFLOP over the TF32 '
          f'tensor-core peak / 3 ({TF32_PEAK / 3e12:.0f} TFLOP/s): '
          f'{1e3 * factor_ops / (TF32_PEAK / 3):.4f} ms [{card}]')
    cold_certificate(k2, args, kw, st, main_block, 'MPC', card)
    # where K2's time goes: the cold factorization and one check interval,
    # then the whole solve without adaptive rho
    probes = [('cold factor + one check, adaptive off',
               dict(kw, max_iter=st.check_interval, adaptive=False)),
              ('adaptive rho off', dict(kw, adaptive=False)),
              ('adaptive rho off, no refinement sweep',
               dict(kw, adaptive=False, kkt_refine=0))]
    for name, pkw in probes:
        res = k2.admm_solve_full(*args, **pkw, block=main_block)
        p_ms, _ = cuda_ms(lambda: k2.admm_solve_full(
            *args, **pkw, block=main_block), 2)
        print(f'# phase 5: K2 probe, {name}: {p_ms:.3f} ms, mean iters '
              f'{float(res[4].float().mean()):.2f} [{card}]')
    # the portfolio batch of phase 6 (n=130, m=172, B=512), with two
    # refinement sweeps, where every instance converges (phase 6)
    portfolio_k2_vs_plain(portfolio, card)
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def k2_plain_by_block(k2, args, kw, block):
    """The plain version run one block at a time.  Blocks do not interact,
    so this computes the same function as one call on the whole batch; its
    batched float32 products (whose summation order the library picks by
    the batch size) then see the batch size the kernel's arithmetic sees,
    which is that of one block."""
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    B = args[0].shape[0]
    with full_f32_matmul():
        parts = [k2.admm_solve_full_plain(*[a[i:i + block] for a in args],
                                          **kw, block=block)
                 for i in range(0, B, block)]
    return [torch.cat([p[k] for p in parts]) for k in range(len(parts[0]))]


def cold_certificate(k2, args, kw, st, block, label, card):
    """K2's certificate ||I - M X|| after the cold sweeps (max over the
    instances) beside the float32 sweeps' on the same inputs
    (torch.matmul at full float32 precision, no TF32); held to twice it."""
    from cvxpygen_tpu_torch.ops.admm_full_kernel import (_form_M, _sweeps,
                                                         ns_cert)
    from cvxpygen_tpu_torch.solvers.admm import (_ns_diag_start,
                                                 full_f32_matmul)
    Ps, As, rho = args[0], args[2], args[5]
    cert = torch.full((Ps.shape[0],), float('nan'), device=Ps.device)
    k2.admm_solve_full(*args, **dict(kw, max_iter=st.check_interval),
                       block=block, cold_cert=cert)
    with full_f32_matmul():
        M = _form_M(Ps, As, st.sigma, rho)
        ref = ns_cert(M, _sweeps(M, _ns_diag_start(M), st.ns_iters,
                                 torch.matmul))
    kmax, rmax = float(cert.max()), float(ref.max())
    print(f'# phase 5: K2 {label}: certificate ||I - M X|| after the cold '
          f'sweeps, max over {Ps.shape[0]} instances: {kmax:.3e} (tensor '
          f'cores, three-pass TF32) against {rmax:.3e} (float32 sweeps in '
          f'torch.matmul); median {float(cert.median()):.3e} against '
          f'{float(ref.median()):.3e} [{card}]')
    check(bool(torch.isfinite(cert).all()), f'K2 {label}: certificate not '
          'finite (or not written)')
    check(kmax <= 2 * rmax, f'K2 {label}: certificate {kmax:.3e} > twice the '
          f'float32 sweeps\' {rmax:.3e}')


def plain_unsettled(a, b):
    """The instances on which two plain K2 runs of one batch stop at other
    iterations or differ in x by more than 1e-3 * max(1, |x|)."""
    viol = ((a[0] - b[0]).abs()
            / torch.clamp(b[0].abs(), min=1.0)).amax(dim=1)
    return (a[4] != b[4]) | (viol > 1e-3)


def iterate_spread(a, b):
    """Instances at other iterations, and the largest |dx| / max(1, |x|)
    where the iterations agree, between two K2 results."""
    same = a[4] == b[4]
    viol = float(((a[0] - b[0]).abs()[same]
                  / torch.clamp(b[0][same].abs(), min=1.0)).max())
    return int((~same).sum()), viol


def portfolio_k2_vs_plain(portfolio, card):
    """K2 against its plain version on the portfolio batch.  This family is
    ill-conditioned: one ulp of q moves its float32 iterates, so the bar is
    relative to that yardstick (the plain version with q one ulp up against
    the plain version): equal status; at most twice the yardstick's count
    of instances at other iterations; where the iterations agree, x within
    max(1e-3, twice the yardstick's) * max(1, |x|).  Twice, because kernel
    and plain version are two roundoff paths, as are the plain version and
    its one-ulp twin."""
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.solvers.admm import (
        ADMMSettings, full_f32_matmul, full_kernel_kwargs)
    pfam, ptheta, _ = portfolio
    pst = ADMMSettings(**PORTFOLIO_SETTINGS_REFINE2)
    pkw = full_kernel_kwargs(pst)
    pargs = per_instance_inputs(pfam, None, B_PORTFOLIO, pst, theta=ptheta)
    pblock = k2.pick_full_block(B_PORTFOLIO, pfam.m, pfam.n)
    pctas = k2.full_layout(pblock, pfam.m, pfam.n)
    print(f'# phase 5: K2 portfolio block {pblock} layout: resident, c = '
          f'{pctas} thread blocks per instance')
    check(pctas == 1, 'K2 at the portfolio block: the resident layout with '
          'c = 1 expected')
    cold_certificate(k2, pargs, pkw, pst, pblock, 'portfolio', card)
    out = k2.admm_solve_full(*pargs, **pkw, block=pblock)
    torch.cuda.synchronize()
    ulp_args = list(pargs)
    ulp_args[1] = pargs[1] * (1.0 + 2.0 ** -23)
    with full_f32_matmul():
        ref = k2.admm_solve_full_plain(*pargs, **pkw, block=pblock)
        ref_ulp = k2.admm_solve_full_plain(*ulp_args, **pkw, block=pblock)
    y_other, y_viol = iterate_spread(ref_ulp, ref)
    n_other, viol = iterate_spread(out, ref)
    print(f'# phase 5: K2 portfolio, B={B_PORTFOLIO} block={pblock}, '
          f'kkt_refine 2: {int((out[5] == 1).sum())} solved (plain '
          f'{int((ref[5] == 1).sum())}), status differs on '
          f'{int((out[5] != ref[5]).sum())}; {n_other} instances at other '
          f'iterations (yardstick {y_other}); same iterations: max '
          f'|dx|/max(1,|x|) {viol:.3e} (yardstick {y_viol:.3e}) [{card}]')
    check(bool(torch.isfinite(out[0]).all()), 'K2 portfolio: non-finite x')
    check(torch.equal(out[5], ref[5]), 'K2 portfolio: status differs')
    check(n_other <= 2 * y_other, f'K2 portfolio: {n_other} instances at '
          f'other iterations > twice the yardstick {y_other}')
    check(viol <= max(1e-3, 2 * y_viol), f'K2 portfolio: max |dx| / '
          f'max(1, |x|) {viol:.3e} > max(1e-3, twice {y_viol:.3e})')


def solve_and_gate(name, solver, theta, refs, counter, card, reps=3,
                   min_frac=1.0):
    """solve_batch(theta, shared_PA=False) once to warm up and ``reps``
    timed; the kernel's launch count is set to 0 just before and read just
    after.  Gates: the kernel was launched, at least ``min_frac`` of the
    instances solved, and the oracle parity bar.  Returns the launches."""
    counter.launches = 0
    out = solver.solve_batch(theta, shared_PA=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solver.solve_batch(theta, shared_PA=False)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    launches = counter.launches
    B = theta.shape[0]
    frac = float(np.mean(out['status'].cpu().numpy() == 1))
    obj = (out['obj'] + out['d']).double().cpu().numpy()
    max_rel, n_bad = parity(obj, refs)
    iters = out['iters'].float()
    n_unsolved = int(np.sum(out['status'].cpu().numpy() != 1))
    print(f'# phase 6: {name}, B={B}: frac_solved {frac} ({n_unsolved} '
          f'unsolved), mean iters {float(iters.mean()):.2f} (max '
          f'{int(iters.max())}), {B / dt:.1f} solves/s, {1e3 * dt:.3f} ms '
          f'per batch, launches {launches}; oracle parity on {len(refs)}: '
          f'max rel {max_rel:.3e} ({n_bad} non-finite) [{card}]')
    check(launches > 0, f'{name}: the kernel was not launched')
    check(frac >= min_frac, f'{name}: frac_solved {frac} < {min_frac}')
    check(n_bad == 0 and max_rel <= PARITY_BAR,
          f'{name}: oracle parity {max_rel:.3e} ({n_bad} non-finite)')
    return launches


def k3_route_status(fam, prob, card):
    """The K3 route at the general row's 6 warm sweeps on the first
    B_K3_SLICE instances: no refinement after a rough warm inverse leaves
    some instances unsolved, and which ones is decided by roundoff in the
    iterations.  Held against the torch loop at kkt_refine=0 (the same
    algorithm without the kernel): the route's status may differ from the
    loop's on at most twice as many instances as the route driven with
    K3's plain version does (the yardstick: the same iterations in torch,
    only summed in another order).  Returns K3's launches."""
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.runtime.torch_family import (
        TorchFamily, canon_batch, qp_bounds_batch)
    from cvxpygen_tpu_torch.solvers.admm import (ADMMSettings, admm_solve,
                                                 full_f32_matmul)
    tf = TorchFamily.from_family(fam, device='cuda')
    data = canon_batch(tf, x_init_batch(fam, prob, B_MAIN)[:B_K3_SLICE])
    l, u = qp_bounds_batch(tf, data['b'])

    def solve(**over):
        st = ADMMSettings(**dict(GENERAL_SETTINGS, **over))
        return admm_solve(data['P'], data['q'], data['A'], l, u, tf.n_zero,
                          st)['status']

    def iterate_plain(*args, block=None):
        with full_f32_matmul():
            return k3.admm_iterate_plain(*args)

    kernel_iterate = k3.admm_iterate
    k3.admm_iterate.launches = 0
    route = solve(use_pallas='auto')
    launches = k3.admm_iterate.launches
    k3.admm_iterate = iterate_plain
    try:
        route_plain = solve(use_pallas='auto')
    finally:
        k3.admm_iterate = kernel_iterate
    loop = solve(use_pallas='never', kkt_solver='ns', kkt_refine=0)
    n_route = int((route != loop).sum())
    n_plain = int((route_plain != loop).sum())
    print(f'# phase 6: K3 route, ns_adapt_iters 6, first {B_K3_SLICE} '
          f'instances: solved {int((route == 1).sum())}, with K3\'s plain '
          f'version {int((route_plain == 1).sum())}, torch loop at '
          f'kkt_refine=0 {int((loop == 1).sum())}; status differs from the '
          f'loop on {n_route} (yardstick, plain version: {n_plain}), K3 '
          f'launches {launches} [{card}]')
    check(launches > 0, 'K3 route: the kernel was not launched')
    check(n_route <= 2 * n_plain, f'K3 route: status differs from the loop '
          f'on {n_route} > twice the yardstick {n_plain}')
    return launches


def k3_route_small(fam, theta, st, card):
    """A batch of B_SMALL_ROUTE instances, which the reference's block rule
    gives no block (B not a multiple of 8): 'auto' runs the refined torch
    loop and launches no K3, so its solve is bitwise the solve with
    use_pallas='never' (statuses, iterations and x)."""
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver
    from cvxpygen_tpu_torch.solvers.admm import pick_block
    solver = CompiledQPSolver(fam, settings=st)
    small = theta[:B_SMALL_ROUTE]
    k3.admm_iterate.launches = 0
    auto = solver.solve_batch(small, shared_PA=False)
    launches = k3.admm_iterate.launches
    loop = solver.solve_batch(
        small, settings=dataclasses.replace(st, use_pallas='never'),
        shared_PA=False)
    same = {k: torch.equal(auto[k], loop[k]) for k in ('status', 'iters',
                                                       'x')}
    print(f'# phase 6: MPC per-instance B={B_SMALL_ROUTE}, '
          f"use_pallas='auto' (block of the reference's rule: "
          f'{pick_block(B_SMALL_ROUTE, fam.m, fam.n, torch.float32)}): K3 '
          f'launches {launches}, solved '
          f'{int((auto["status"] == 1).sum())}, mean iters '
          f'{float(auto["iters"].float().mean()):.2f}; bitwise equal to '
          f"use_pallas='never': {same} [{card}]")
    check(launches == 0, f'B={B_SMALL_ROUTE}: the route launched K3')
    check(all(same.values()), f'B={B_SMALL_ROUTE}: the auto route differs '
          f"from use_pallas='never': {same}")


def portfolio_problem(ct, n=20, m=5):
    """The portfolio family of tests/problems.py:104-126 (reference
    tests/test_E2E_QP.py:76-110) in the port's modeling layer."""
    w = ct.Variable(n, name='w')
    delta_w = ct.Variable(n, name='delta_w')
    f = ct.Variable(m, name='f')
    a = ct.Parameter(n, name='a')
    F = ct.Parameter((n, m), name='F')
    Sig_f_sqrt = ct.Parameter((m, m), name='Sig_f_sqrt')
    d_sqrt = ct.Parameter(n, name='d_sqrt')
    k_tc = ct.Parameter(n, nonneg=True, name='k_tc')
    k_sh = ct.Parameter(n, nonneg=True, name='k_sh')
    w_prev = ct.Parameter(n, name='w_prev')
    L = ct.Parameter(nonneg=True, name='L')
    objective = ct.Maximize(a @ w
                            - ct.sum_squares(Sig_f_sqrt @ f)
                            - ct.sum_squares(ct.multiply(d_sqrt, w))
                            - k_tc @ ct.abs(delta_w)
                            + k_sh @ ct.minimum(0, w))
    constraints = [f == F.T @ w,
                   np.ones(n) @ w == 1,
                   ct.norm(w, 1) <= L,
                   delta_w == w - w_prev]
    return ct.Problem(objective, constraints)


def assign_portfolio(prob, seed=0, n=20, m=5):
    np.random.seed(seed)
    prob.param_dict['a'].value = np.random.randn(n)
    prob.param_dict['F'].value = np.round(np.random.randn(n, m))
    prob.param_dict['Sig_f_sqrt'].value = np.diag(np.random.rand(m))
    prob.param_dict['d_sqrt'].value = np.random.rand(n)
    prob.param_dict['k_tc'].value = 0.01 * np.ones(n)
    prob.param_dict['k_sh'].value = 0.05 * np.ones(n)
    prob.param_dict['w_prev'].value = np.zeros(n)
    prob.param_dict['L'].value = 1.6
    return prob


def portfolio_batch():
    """The portfolio family (20 assets, 5 factors), B_PORTFOLIO rows with
    per-instance rounded-normal F and normal a (bench.py:473-486), and the
    float64 oracle's objectives of the first N_ORACLE_PORTFOLIO rows."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    pprob = assign_portfolio(portfolio_problem(ct))
    pfam = canonicalize(pprob)
    check((pfam.n, pfam.m) == (130, 172),
          f'portfolio shape {pfam.n}, {pfam.m}')
    rng = np.random.default_rng(7)
    base = pfam.pack_theta(params=pprob.parameters())
    Fi = [pi for pi in pfam.param_info if pi.name == 'F'][0]
    ai = [pi for pi in pfam.param_info if pi.name == 'a'][0]
    ptheta = np.tile(base, (B_PORTFOLIO, 1))
    ptheta[:, Fi.offset:Fi.offset + Fi.flat_size] = np.round(
        rng.standard_normal((B_PORTFOLIO, Fi.flat_size)))
    ptheta[:, ai.offset:ai.offset + ai.flat_size] = rng.standard_normal(
        (B_PORTFOLIO, ai.flat_size))
    t0 = time.perf_counter()
    prefs = oracle_objs(pfam, ptheta, N_ORACLE_PORTFOLIO)
    print(f'# portfolio: n={pfam.n}, m={pfam.m}, B={B_PORTFOLIO}; oracle on '
          f'{N_ORACLE_PORTFOLIO} instances {time.perf_counter() - t0:.1f} s')
    return pfam, ptheta, prefs


def phase_per_instance(fam, prob, refs, card, portfolio):
    """The per-instance main path: MPC through K2 and through the K3 route,
    portfolio with per-instance factor loadings through K2."""
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings

    theta = x_init_batch(fam, prob, B_MAIN)
    st = ADMMSettings(**GENERAL_SETTINGS)
    k2_launches = solve_and_gate(
        'MPC per-instance through K2', CompiledQPSolver(fam, settings=st),
        theta, refs, k2.admm_solve_full, card)

    # the K3 route: no refinement sweep in the fused iterations, so at the
    # general row's 6 warm sweeps it is held to the torch loop without
    # refinement; with the shared row's 12 (bench.py:142-152) it solves
    # every instance
    k3_launches = k3_route_status(fam, prob, card)
    st12 = ADMMSettings(**dict(GENERAL_SETTINGS, use_pallas='auto',
                               ns_adapt_iters=12))
    k3_launches += solve_and_gate(
        'MPC per-instance through K3, ns_adapt_iters 12',
        CompiledQPSolver(fam, settings=st12), theta, refs, k3.admm_iterate,
        card, reps=1)
    k3_route_small(fam, theta, st12, card)

    pfam, ptheta, prefs = portfolio
    psolver = CompiledQPSolver(pfam,
                               settings=ADMMSettings(**PORTFOLIO_SETTINGS))
    check(not psolver._use_shared(ptheta, 'auto'),
          'portfolio batch would take the shared path')
    k2_launches += solve_and_gate(
        'portfolio varying P through K2, kkt_refine 1', psolver, ptheta,
        prefs, k2.admm_solve_full, card, reps=1,
        min_frac=1.0 - PORTFOLIO_UNSOLVED_SHARE)
    psolver.settings = ADMMSettings(**PORTFOLIO_SETTINGS_REFINE2)
    k2_launches += solve_and_gate(
        'portfolio varying P through K2, kkt_refine 2', psolver, ptheta,
        prefs, k2.admm_solve_full, card, reps=1)
    return k2_launches, k3_launches


def block_sweep(card):
    """``--block-sweep``: kernel K2 at other blocks than the main path's,
    on the portfolio batch at the bench's settings and on MPC general at
    B=2048: instances solved, mean iterations and kernel time per block.
    The block is part of K2's answer; this shows what it costs and what it
    changes on the card."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.solvers.admm import (ADMMSettings,
                                                 full_kernel_kwargs)
    prob = assign_mpc(mpc_problem(ct))
    fam = canonicalize(prob)
    pfam, ptheta, _ = portfolio_batch()
    cases = [('portfolio', ADMMSettings(**PORTFOLIO_SETTINGS), pfam, None,
              ptheta, (1, 4, 8, 16, 32)),
             ('MPC general', ADMMSettings(**GENERAL_SETTINGS), fam, prob,
              None, (1, 8, 16))]
    for name, st, f, pr, theta, blocks in cases:
        kw = full_kernel_kwargs(st)
        args = per_instance_inputs(f, pr, B_MAIN if theta is None
                                   else B_PORTFOLIO, st, theta=theta)
        B = args[0].shape[0]
        for block in blocks:
            k2.admm_solve_full(*args, **kw, block=block)        # warm
            ms, out = cuda_ms(lambda: k2.admm_solve_full(*args, **kw,
                                                         block=block), 2)
            print(f'# block sweep: {name}, B={B}, block {block}: solved '
                  f'{int((out[5] == 1).sum())}, mean iters '
                  f'{float(out[4].float().mean()):.2f}, kernel {ms:.3f} ms '
                  f'[{card}]')
        # at the main path's block, q moved by one or two ulp: how far
        # roundoff alone moves the count of instances solved
        block = k2.pick_full_block(B, f.m, f.n)
        for ulps in (1, -1, 2):
            a = list(args)
            a[1] = args[1] * (1.0 + ulps * 2.0 ** -23)
            out = k2.admm_solve_full(*a, **kw, block=block)
            print(f'# block sweep: {name}, block {block}, q moved {ulps:+d} '
                  f'ulp: solved {int((out[5] == 1).sum())}, mean iters '
                  f'{float(out[4].float().mean()):.2f}')


# ---------------------------------------------------------------------------
# the banded path: kernels K4 and K5
# ---------------------------------------------------------------------------

def charging_problem(ct, T=CHARGING_T):
    """The charging family of bench.py:544-566 (reference
    examples/charging.ipynb) with the bench's parameter values."""
    u = ct.Variable(T, name='u')
    qv = ct.Variable(T + 1, name='q')
    p = ct.Parameter(T, nonneg=True, name='p')
    s = ct.Parameter(T, nonneg=True, name='s')
    D = ct.Parameter(nonneg=True, name='D')
    C = ct.Parameter(nonneg=True, name='C')
    Q = ct.Parameter(nonneg=True, name='Q')
    gamma = ct.Parameter(nonneg=True, name='gamma')
    objective = ct.Minimize(p @ u + s @ ct.abs(u)
                            + gamma * ct.sum_squares(u))
    constraints = [qv[1:] == qv[:-1] + u, -D <= u, u <= C,
                   ct.Constant(0) <= qv, qv <= Q,
                   qv[0] == 0, qv[T] == Q]
    prob = ct.Problem(objective, constraints)
    p.value = np.concatenate((
        3 * np.ones(int(3 * T / 24)), 5 * np.ones(int(7 * T / 24)),
        1 * np.ones(T - int(3 * T / 24) - int(7 * T / 24))))
    s.value = 0.1 * p.value
    Q.value = 1.0
    C.value = 3 * Q.value / T
    D.value = 2 * C.value
    gamma.value = 100.0
    return prob


def charging_batch(fam, prob, B, vary_gamma=False):
    """B instances: the prices p times U(0.8, 1.2) from default_rng(2)
    (bench.py:571-576); with ``vary_gamma`` also gamma times U(0.5, 1.5)
    per instance from default_rng(3), so that P differs per instance."""
    base = fam.pack_theta(params=prob.parameters())
    pi = [x for x in fam.param_info if x.name == 'p'][0]
    theta = np.tile(base, (B, 1))
    theta[:, pi.offset:pi.offset + pi.flat_size] *= np.random.default_rng(
        2).uniform(0.8, 1.2, (B, pi.flat_size))
    if vary_gamma:
        gi = [x for x in fam.param_info if x.name == 'gamma'][0]
        theta[:, gi.offset] *= np.random.default_rng(3).uniform(0.5, 1.5, B)
    return theta


def canon_vectors(fam, theta):
    """q, d and b of each row of theta in float64 (Family.canon_numpy
    without the dense P and A)."""
    tt = np.concatenate([theta, np.ones((theta.shape[0], 1))], axis=1)
    q = (fam.q_map @ tt.T).T
    d = np.asarray(fam.d_map @ tt.T).reshape(-1)
    if fam.d_quad is not None:
        d = d + np.einsum('bp,bp->b', tt, (fam.d_quad @ tt.T).T)
    b = (fam.b_map @ tt.T).T
    return np.asarray(q), d, np.asarray(b)


def dense_refs(fam, theta, dev, shared, **over):
    """Objectives (with d) of the port's dense ADMM in float64 at eps 1e-6
    (or the settings ``over`` changes) on the rows of theta:
    admm_solve_shared on the shared P and A of row 0, or admm_solve per
    instance.  Every row must solve."""
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings, admm_solve
    from cvxpygen_tpu_torch.solvers.admm_shared import admm_solve_shared
    q, d, b = canon_vectors(fam, theta)
    bounds = [fam.qp_bounds(bi) for bi in b]

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=dev)

    l, u = t([lu[0] for lu in bounds]), t([lu[1] for lu in bounds])
    st = ADMMSettings(**dict(DENSE_REF_SETTINGS, **over))
    if shared:
        P, _, _, A, _ = fam.canon_numpy(theta[0])
        res = admm_solve_shared(t(P), t(q), t(A), l, u, fam.n_zero, st)
    else:
        PA = [fam.canon_numpy(th) for th in theta]
        res = admm_solve(t([c[0] for c in PA]), t(q), t([c[3] for c in PA]),
                         l, u, fam.n_zero, st)
    status = res['status'].cpu().numpy()
    check(bool(np.all(status == 1)), f'float64 reference: status {status}')
    return list(res['obj'].cpu().numpy() + d), res['iters'].cpu().numpy()


def k4_bound(nb_tot, nb, s, B):
    """Least time of K4's work: the larger of the FP32 operations (every
    packed block applied once per right-hand side) over the FP32 peak and
    the bytes (b in, x out, the factor once) over the HBM rate."""
    ops = 2.0 * B * nb_tot * s * s
    nbytes = 4.0 * (2 * nb * s * B + nb_tot * s * s)
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops, nbytes)


def k5_bound(nb_tot, s, n, m, nnz_a, nnz_p, B, n_active, n_iters):
    """Least time of K5's work on these inputs: the FP32 operations that
    the function needs over the FP32 peak, against the bytes (the shared
    inputs and each instance's state once in, once out) over the HBM rate.
    Operations, counted on the real data and not on the kernel's padded
    layouts (r_max rows per block, dense P blocks): per active instance
    and iteration the A' and A products (nnz(A) multiply-adds each) and
    the CR solve (every packed factor block applied once); per instance
    and call the residual and certificate products, four with A and two
    with P (nnz(P) each).  The element-wise updates are left out."""
    per_iter = 2 * nnz_a + nb_tot * s * s
    per_check = 4 * nnz_a + 2 * nnz_p
    ops = 2.0 * (n_active * n_iters * per_iter + B * per_check)
    shared_words = nb_tot * s * s + nnz_a + nnz_p + n + 3 * m
    inst_words = (2 * n + 4 * m + 1          # q, x, l, u, z, y, done
                  + n + 2 * m + 5)           # x, z, y, 4 residuals, flags
    nbytes = 4.0 * (shared_words + B * inst_words)
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops, nbytes)


def banded_args(solver, theta, settings):
    """The shared banded engine's kernel arguments at the start state on
    this batch (solvers/admm_banded_shared.banded_kernel_args)."""
    from cvxpygen_tpu_torch.runtime.torch_family import (canon_batch_sparse,
                                                         qp_bounds_batch)
    from cvxpygen_tpu_torch.solvers.admm_banded_shared import \
        banded_kernel_args
    data = canon_batch_sparse(solver.jf, theta)
    l, u = qp_bounds_batch(solver.jf, data['b'])
    return banded_kernel_args(solver.struct, solver.grouped,
                              data['pvals'][0], data['q'], data['avals'][0],
                              l, u, solver.jf.n_zero, settings,
                              index=solver.index)


def mid_solve_k4_call(solver, theta, settings, call):
    """(factor, meta, rhs) of K4's call number ``call`` in a solve of this
    batch: a right-hand side from the middle of a solve, with the factor
    of that moment."""
    from cvxpygen_tpu_torch.solvers import admm_banded_shared as engine
    real = engine.cr_solve
    seen = []

    def spy(packed, meta, rhs):
        if len(seen) == call:
            seen.append((packed.clone(), meta, rhs.clone()))
        else:
            seen.append(None)
        return real(packed, meta, rhs)

    engine.cr_solve = spy
    try:
        stop = (call // settings.check_interval + 1) * settings.check_interval
        solver.solve_batch(theta, settings=dataclasses.replace(
            settings, max_iter=stop))
    finally:
        engine.cr_solve = real
    check(len(seen) > call, f'the solve made {len(seen)} K4 calls')
    return seen[call]


def k4_l2_bytes(nb_tot, nb, s, B, group):
    """Bytes K4 moves through L2 in one call: b in and x out once, and
    the factor once per thread block (ceil(B / group) blocks)."""
    return 4.0 * (2 * nb * s * B + -(-B // group) * nb_tot * s * s)


def compare_k4(solver, theta, settings, card):
    """K4 against its plain version on the charging factor of the shared
    path's first factorization (random right-hand sides at B = 1, 3, 256
    and 2048, and a mid-solve call), bitwise equal on a second call and at
    every pinned group; times of K4 by group at B = 256 and 2048, the plain
    version, the bound and torch.cholesky_solve of the dense Cholesky
    factor of the same M."""
    from cvxpygen_tpu_torch.ops import banded_shared_kernel as k45
    from cvxpygen_tpu_torch.ops.block_tridiag import bt_matvec
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    dev = solver.device
    st = solver.struct
    nb, s, B = st.nb, st.s, theta.shape[0]
    args = banded_args(solver, theta, settings)
    fac, meta, D_M, L_M = args[0], args[1], args[6], args[7]
    gen = torch.Generator(device=dev).manual_seed(0)
    x_true = torch.randn((K4_BATCHES[-1], nb, s), generator=gen, device=dev,
                         dtype=torch.float64)
    b_true = bt_matvec(D_M.double()[None], L_M.double()[None], x_true)
    b_all = b_true.permute(1, 2, 0).float().contiguous()
    cases = [('b = M x of random x', fac, meta,
              b_all[:, :, :nb_b].contiguous()) for nb_b in K4_BATCHES]
    cases.append(('mid-solve rhs (call 120)',)
                 + mid_solve_k4_call(solver, theta, settings, 120))
    max_abs = 0.0
    for name, f, m, b in cases:
        Bc = b.shape[-1]
        x = k45.cr_solve(f, m, b)
        torch.cuda.synchronize()
        x_ref = k45.cr_solve_plain(f, m, b)
        x64 = k45.cr_solve_plain(f.double(), m, b.double())
        check(bool(torch.isfinite(x).all()), f'K4 {name}: non-finite x')
        scale = torch.clamp(x_ref.abs().amax(dim=(0, 1)), min=1.0)
        err = (x - x_ref).abs().amax(dim=(0, 1))
        viol = float((err / scale).max())
        own = float(((x_ref.double() - x64).abs().amax(dim=(0, 1))
                     / scale.double()).max())
        max_abs = max(max_abs, float(err.max()))
        again = torch.equal(k45.cr_solve(f, m, b), x)
        groups = {g: torch.equal(k45.cr_solve(f, m, b, group=g), x)
                  for g in (1, 2, 4, 8)}
        plan = k45.cr_launch_plan(nb, s, Bc)
        check(k45._LIB_CR.cr_solve_smem_bytes(nb, s, plan[0], plan[1])
              == plan[2], f'K4 {name}: the shared-memory rule')
        print(f'# phase 7: K4 {name}, B={Bc} (group {plan[0]}, steps of '
              f'{plan[1]} block pairs, {plan[2]} B of shared memory): max '
              f'|dx| {float(err.max()):.3e}, max |dx|/max(1,|x|_inf) '
              f'{viol:.3e} (bar {K4_TOL}); the plain version against '
              f'float64: {own:.3e}; a second call bitwise equal {again}; '
              f'groups 1, 2, 4, 8 bitwise equal to it: '
              + ', '.join(str(v) for v in groups.values()))
        check(viol <= K4_TOL, f'K4 {name}: {viol:.3e} > {K4_TOL}')
        check(again and all(groups.values()),
              f'K4 {name}: a second call or a pinned group differs')
    # the group sweep: instances per thread block at the main batch and at
    # 2048
    for nb_b in (B, K4_BATCHES[-1]):
        b = b_all[:, :, :nb_b].contiguous()
        line = []
        for g in (1, 2, 4, 8):
            k45.cr_solve(fac, meta, b, group=g)             # warm
            g_ms, _ = cuda_ms(lambda: k45.cr_solve(fac, meta, b, group=g),
                              50)
            line.append(f'{g}: {g_ms:.4f} ms')
        print(f'# phase 7: K4 by group at B={nb_b}: ' + ', '.join(line)
              + f' (the rule: {k45.cr_launch_plan(nb, s, nb_b)[0]}) [{card}]')
    b = b_all[:, :, :B].contiguous()
    k45.cr_solve(fac, meta, b)                              # warm
    ms, _ = cuda_ms(lambda: k45.cr_solve(fac, meta, b), 50)
    k45.cr_solve_plain(fac, meta, b)                        # warm
    plain_ms, _ = cuda_ms(lambda: k45.cr_solve_plain(fac, meta, b), 5)
    # the library yardstick: the dense M (n_pad x n_pad) and its Cholesky
    # factor, built outside the timed window
    n_pad = nb * s
    with full_f32_matmul():
        Md = torch.zeros((nb, s, nb, s), dtype=torch.float64, device=dev)
        idx = torch.arange(nb, device=dev)
        Md[idx, :, idx, :] = D_M.double()
        Md[idx[1:], :, idx[:-1], :] = L_M.double()
        Md[idx[:-1], :, idx[1:], :] = L_M.double().transpose(1, 2)
        # factored in float64 (float32 Cholesky of this M may meet a
        # non-positive pivot), then applied in float32 like K4
        Lc = torch.linalg.cholesky(Md.reshape(n_pad, n_pad)).float()
        b2 = b.reshape(n_pad, B)
        torch.cholesky_solve(b2, Lc)                        # warm
        lib_ms, x_lib = cuda_ms(lambda: torch.cholesky_solve(b2, Lc), 10)
    x_k4 = k45.cr_solve(fac, meta, b).reshape(n_pad, B)
    lib_diff = float(((x_lib - x_k4).abs().amax(dim=0)
                      / torch.clamp(x_k4.abs().amax(dim=0), min=1.0)).max())
    bound_ms, bound_by, ops, nbytes = k4_bound(meta['total'], nb, s, B)
    l2 = k4_l2_bytes(meta['total'], nb, s, B,
                     k45.cr_launch_plan(nb, s, B)[0])
    print(f'# phase 7: K4 at nb={nb}, s={s}, B={B} ({meta["total"]} packed '
          f'blocks): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
          f'{bound_ms:.5f} ms ({bound_by}; {ops / 1e6:.1f} MFLOP, '
          f'{nbytes / 1e6:.2f} MB), L2 bytes per call {l2 / 1e6:.2f} MB, '
          f'torch.cholesky_solve {lib_ms:.4f} ms '
          f'(max |dx|/max(1,|x|) to K4 {lib_diff:.2e}) [{card}]')
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms)


def k5_check(out, ref, kw, label):
    """Hold K5's outputs against the plain version's (the bars of
    K5_TOL and K5_FLAG_BAND).  Returns the largest absolute difference of
    x, z, y."""
    max_abs = 0.0
    for name, o, r in zip('xzy', out[:3], ref[:3]):
        check(bool(torch.isfinite(o).all()), f'K5 {label}: non-finite {name}')
        err = (o - r).abs().amax(dim=(0, 1))
        scale = torch.clamp(r.abs().amax(dim=(0, 1)), min=1.0)
        viol = float((err / scale).max())
        max_abs = max(max_abs, float(err.max()))
        print(f'# phase 8: K5 {label}, {name}: max |d| {float(err.max()):.3e}'
              f', max |d|/max(1,|{name}|_inf) {viol:.3e}')
        check(viol <= K5_TOL, f'K5 {label} {name}: {viol:.3e} > {K5_TOL}')
    # rp and rd are norms of differences of terms of the size of rp_den and
    # rd_den, so their roundoff is relative to those
    scales = (ref[5], ref[6], ref[5], ref[6])
    viols = []
    for name, o, r, sc in zip(('rp', 'rd', 'rp_den', 'rd_den'), out[3:7],
                              ref[3:7], scales):
        viol = float(((o - r).abs() / torch.clamp(sc.abs(), min=1.0)).max())
        viols.append(f'{name} {viol:.2e}')
        check(viol <= K5_TOL, f'K5 {label} {name}: {viol:.3e} > {K5_TOL}')
    flags, flags_ref = out[7], ref[7]
    diff = (flags != flags_ref).nonzero().flatten().tolist()
    for i in diff:
        check(int((flags[i] ^ flags_ref[i]) & 6) == 0,
              f'K5 {label}: infeasibility flags differ at instance {i}')
        rp, rd, rpd, rdd = (float(v[i]) for v in ref[3:7])
        thr_p = kw['eps_abs'] + kw['eps_rel'] * rpd
        thr_d = kw['eps_abs'] + kw['eps_rel'] * rdd
        gap = min(abs(rp - thr_p) / max(1.0, thr_p),
                  abs(rd - thr_d) / max(1.0, thr_d))
        print(f'# phase 8: K5 {label}: ok flag differs at instance {i}: rp '
              f'{rp:.6e} (threshold {thr_p:.6e}), rd {rd:.6e} (threshold '
              f'{thr_d:.6e}), closest gap {gap:.2e}')
        check(gap <= K5_FLAG_BAND, f'K5 {label}: flag differs at {i} '
              f'{gap:.2e} from its threshold')
    print(f'# phase 8: K5 {label}: residuals |d| / max(1, rp_den or rd_den)'
          f' {", ".join(viols)}; flags differ on {len(diff)} instances')
    return max_abs


def k5_l2_bytes(nb_tot, nb, s, r_max, B, group, n_iters):
    """Bytes K5 moves through L2 in one call, by its design: per thread
    block the CR factor and B0/B1 twice (the A' and A products) every
    iteration, and B0/B1 twice and D_P, L_P once in the residual pass; per
    instance its x, z, y in, its q, l, u every iteration and once more in
    the residual pass, x, z, y again for the deltas, x, z, y out and five
    results."""
    win = nb * r_max * s
    per_block = (n_iters * (nb_tot * s * s + 4 * win)
                 + 4 * win + (2 * nb - 1) * s * s)
    nx, nr = nb * s, nb * r_max
    per_inst = (n_iters + 4) * (nx + 2 * nr) + 5
    return 4.0 * (-(-B // group) * per_block + B * per_inst)


def k5_groups(k45, fn_args, done, kw, out, label):
    """K5 again at the default plan and at every pinned group: bitwise
    equal to ``out`` (a call's own clones of the in/out state)."""
    def again(group=None):
        a = [t.clone() if isinstance(t, torch.Tensor) else t for t in fn_args]
        return k45.banded_shared_chunk(*a, done, **kw, group=group)

    same = {g: all(torch.equal(x, y) for x, y in zip(again(g), out))
            for g in (None, 1, 2, 4, 8)}
    print(f'# phase 8: K5 {label}: a second call bitwise equal '
          f'{same[None]}; groups 1, 2, 4, 8 bitwise equal to it: '
          + ', '.join(str(same[g]) for g in (1, 2, 4, 8)))
    check(all(same.values()),
          f'K5 {label}: a second call or a pinned group differs')


def compare_k5(solver, theta_cmp, theta_main, settings, card):
    """K5 against its plain version on the scaled MPC H=30 data at B=256,
    from the zero start and from a mid-solve state with every fifth
    instance done, at B=257 (a partial last group) and at B=2048 (held to
    the same bar), each bitwise equal on a second call and at every pinned
    group of instances per thread block; then K5's time by group at B=256
    and 2048, its L2 bytes per call and the bound."""
    from cvxpygen_tpu_torch.ops import banded_shared_kernel as k45
    kw = dict(sigma=settings.sigma, alpha=settings.alpha,
              eps_abs=settings.eps_abs, eps_rel=settings.eps_rel,
              check_interval=settings.check_interval, kkt_refine=0)
    dev = solver.device
    st, ga = solver.struct, solver.grouped

    def call(fn, args, done):
        a = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
        return fn(*a, done, **kw)

    def plan(B):
        return k45.chunk_launch_plan(st.nb, st.s, ga.r_max, B, None,
                                     k45._sm_count(dev))

    args = banded_args(solver, theta_cmp, settings)
    B = theta_cmp.shape[0]
    done = torch.zeros((1, 1, B), dtype=torch.int32, device=dev)
    max_abs = 0.0
    out = call(k45.banded_shared_chunk, args, done)
    torch.cuda.synchronize()
    max_abs = max(max_abs, k5_check(out, call(
        k45.banded_shared_chunk_plain, args, done), kw, f'B={B} zero start'))
    k5_groups(k45, args, done, kw, out, f'B={B} zero start')
    # mid-solve: three more kernel calls from there, every fifth instance
    # marked done
    state = list(args[:-3]) + list(out[:3])
    for _ in range(3):
        state[-3:] = list(call(k45.banded_shared_chunk, state, done)[:3])
    done_mid = done.clone()
    done_mid[..., ::5] = 1
    out = call(k45.banded_shared_chunk, state, done_mid)
    torch.cuda.synchronize()
    ref = call(k45.banded_shared_chunk_plain, state, done_mid)
    label = f'B={B} mid-solve, every fifth instance done'
    max_abs = max(max_abs, k5_check(out, ref, kw, label))
    k5_groups(k45, state, done_mid, kw, out, label)
    for o, a in zip(out[:3], state[-3:]):
        check(torch.equal(o[..., ::5], a[..., ::5]),
              'K5: a done instance changed')

    # a partial last group at every pinned group (257 = 32 * 8 + 1)
    Bp = B + 1
    args = banded_args(solver, theta_main[:Bp], settings)
    done = torch.zeros((1, 1, Bp), dtype=torch.int32, device=dev)
    out = call(k45.banded_shared_chunk, args, done)
    max_abs = max(max_abs, k5_check(out, call(
        k45.banded_shared_chunk_plain, args, done), kw,
        f'B={Bp} zero start'))
    k5_groups(k45, args, done, kw, out, f'B={Bp} zero start')

    args = banded_args(solver, theta_main, settings)
    Bm = theta_main.shape[0]
    done = torch.zeros((1, 1, Bm), dtype=torch.int32, device=dev)
    out = call(k45.banded_shared_chunk, args, done)        # warm
    max_abs = max(max_abs, k5_check(out, call(
        k45.banded_shared_chunk_plain, args, done), kw, f'B={Bm} zero start'))
    k5_groups(k45, args, done, kw, out, f'B={Bm} zero start')
    # the group sweep: instances per thread block at B=256 and at the main
    # batch
    nb_tot = args[1]['total']
    for nb_b in (B, Bm):
        a = [t.clone() if isinstance(t, torch.Tensor) else t
             for t in banded_args(solver, theta_main[:nb_b], settings)]
        d = torch.zeros((1, 1, nb_b), dtype=torch.int32, device=dev)
        line = []
        for g in (1, 2, 4, 8):
            k45.banded_shared_chunk(*a, d, **kw, group=g)     # warm
            g_ms, _ = cuda_ms(
                lambda: k45.banded_shared_chunk(*a, d, **kw, group=g), 5)
            l2 = k5_l2_bytes(nb_tot, st.nb, st.s, ga.r_max, nb_b, g,
                             settings.check_interval)
            line.append(f'{g}: {g_ms:.4f} ms ({l2 / 1e9:.3f} GB L2)')
        g0, tile, gt, smem = plan(nb_b)
        print(f'# phase 8: K5 by group at B={nb_b}: ' + ', '.join(line)
              + f' (the rule: group {g0}, steps of {tile} CR block pairs '
              f'and {gt} A blocks, {smem} B of shared memory) [{card}]')
        check(k45._LIB_CHUNK.banded_chunk_smem_bytes(
            st.nb, st.s, ga.r_max, g0, tile, gt) == smem,
            f'K5 shared-memory rule at B={nb_b}')
    a = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
    ms, _ = cuda_ms(lambda: k45.banded_shared_chunk(*a, done, **kw), 5)
    a = [t.clone() if isinstance(t, torch.Tensor) else t for t in args]
    k45.banded_shared_chunk_plain(*a, done, **kw)           # warm
    plain_ms, _ = cuda_ms(
        lambda: k45.banded_shared_chunk_plain(*a, done, **kw), 1)
    bound_ms, bound_by, ops, nbytes = k5_bound(
        nb_tot, st.s, st.n, st.m, len(st.a_row), len(st.p_row), Bm,
        Bm, settings.check_interval)
    g0 = plan(Bm)[0]
    l2, l2_one = (k5_l2_bytes(nb_tot, st.nb, st.s, ga.r_max, Bm, g,
                              settings.check_interval) for g in (g0, 1))
    print(f'# phase 8: K5 at nb={st.nb}, s={st.s}, r_max={ga.r_max}, B={Bm}, '
          f'{settings.check_interval} iterations (group {g0}): kernel '
          f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms '
          f'({bound_by}; {ops / 1e9:.2f} GFLOP FP32, {nbytes / 1e6:.1f} MB), '
          f'L2 bytes per call {l2 / 1e9:.3f} GB (one instance per block: '
          f'{l2_one / 1e9:.3f}) [{card}]')
    return dict(max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def time_solve(solver, theta, reps, counter=None, **kw):
    """One solve_batch with the kernel's launch count (``counter``) set to
    0 just before it and read just after, then ``reps`` timed (host clock
    around calls ending in a synchronize).  Returns (out, seconds per call,
    the first call's launches, the first call's iterations)."""
    if counter is not None:
        counter.launches = 0
    out = solver.solve_batch(theta, **kw)
    launches = counter.launches if counter is not None else 0
    first_iters = out['iters'].float()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solver.solve_batch(theta, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps, launches, first_iters


def kernel_share(solver, theta, name, card):
    """One more solve_batch with CUDA events around each launch of the
    shared banded engine's kernel ``name`` (``cr_solve`` or
    ``banded_shared_chunk`` in solvers/admm_banded_shared.py): prints the
    kernel's summed device time against the solve's wall time.  Its
    launches are not the main path's (those were read before)."""
    from cvxpygen_tpu_torch.solvers import admm_banded_shared as engine
    real = getattr(engine, name)
    events = []

    def timed(*args, **kw):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = real(*args, **kw)
        ev[1].record()
        events.append(ev)
        return out

    setattr(engine, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve_batch(theta)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    finally:
        setattr(engine, name, real)
    k_ms = sum(a.elapsed_time(b) for a, b in events)
    print(f'# phase 9: where the time goes, B={theta.shape[0]}: {wall:.3f} ms '
          f'per batch, of which {name} {k_ms:.3f} ms in {len(events)} '
          f'launches ({k_ms / max(1, len(events)):.4f} ms per launch; CUDA '
          f'events), the rest {wall - k_ms:.3f} ms (torch set-up, matvecs, '
          f'checks and host) [{card}]')


def gate_banded(name, out, refs, dt, launches, first_iters, card,
                kernel=None):
    """Every instance solved, finite, within the parity bar of its
    reference; prints solves/s, the kernel's launches and the first call's
    iterations beside the timed call's (the float32 M is assembled with
    atomic adds, so the two may differ where the stopping rule is close to
    float32 roundoff)."""
    B = out['status'].shape[0]
    frac = float(np.mean(out['status'].cpu().numpy() == 1))
    obj = (out['obj'] + out['d']).double().cpu().numpy()
    max_rel, n_bad = parity(obj, refs)
    iters = out['iters'].float()
    what = f', {kernel} launches {launches}' if kernel else ''
    print(f'# phase 9: {name}, B={B}: frac_solved {frac}, mean iters '
          f'{float(iters.mean()):.2f} (max {int(iters.max())}; first call '
          f'{float(first_iters.mean()):.2f}, max {int(first_iters.max())}), '
          f'{B / dt:.1f} solves/s, {1e3 * dt:.3f} ms per batch{what}; parity '
          f'on {len(refs)}: max rel {max_rel:.3e} ({n_bad} non-finite) '
          f'[{card}]')
    check(bool(np.all(np.isfinite(out['x'].cpu().numpy()))),
          f'{name}: non-finite x')
    check(frac == 1.0, f'{name}: frac_solved {frac} < 1')
    check(n_bad == 0 and max_rel <= PARITY_BAR,
          f'{name}: parity {max_rel:.3e} ({n_bad} non-finite)')


def phase_banded(card, dev='cuda'):
    """Phases 7-9: K4 and K5 against their plain versions, then the banded
    main path at full width.  Returns the kernels' numbers and launches."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch import cpg
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import banded_shared_kernel as k45
    from cvxpygen_tpu_torch.runtime.solver import (CompiledBandedQPSolver,
                                                   make_compiled_solver)
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings

    t0 = time.perf_counter()
    cprob = charging_problem(ct)
    cfam = canonicalize(cprob)
    cst = ADMMSettings(**CHARGING_SETTINGS)
    csolver = CompiledBandedQPSolver(cfam, settings=cst, device=dev)
    check(csolver.struct.nb > 96, f'charging nb {csolver.struct.nb}')
    ctheta = charging_batch(cfam, cprob, B_CHARGING)
    ix = csolver.index
    tables = {name: tuple(getattr(ix, name).shape) for name in (
        'm_table', 'av_table', 'atv_table', 'pv_table')}
    print(f'# charging T={CHARGING_T}: n={cfam.n}, m={cfam.m}, '
          f's={csolver.struct.s}, nb={csolver.struct.nb}, '
          f'r_max={csolver.grouped.r_max}; set-up '
          f'{time.perf_counter() - t0:.1f} s')
    print(f'# phase 9: segment-sum gather tables (segments, max_count): '
          + ', '.join(f'{k} {v}' for k, v in tables.items())
          + f'; largest max_count {max(v[1] for v in tables.values())} '
          f'(nnz: A {len(ix.a_row)}, P {len(ix.p_row)}, M pairs '
          f'{len(ix.slots)})')
    mprob = assign_mpc(mpc_problem(ct, H=30))
    mfam = canonicalize(mprob)
    mst = ADMMSettings(**MPC30_SETTINGS)
    msolver = make_compiled_solver(mfam, 'ADMM', settings=mst, device=dev)
    check(msolver.solver_name == 'ADMM_BANDED',
          f'MPC H=30 routes to {msolver.solver_name}')
    check(msolver.struct.nb <= 96, f'MPC H=30 nb {msolver.struct.nb}')
    mtheta = x_init_batch(mfam, mprob, B_MAIN)
    print(f'# MPC H=30: n={mfam.n}, m={mfam.m}, s={msolver.struct.s}, '
          f'nb={msolver.struct.nb}, r_max={msolver.grouped.r_max}')

    k4_numbers = compare_k4(csolver, ctheta, cst, card)
    k5_numbers = compare_k5(msolver, mtheta[:B_CMP], mtheta, mst, card)

    # float64 references (the dense ADMM loops at eps 1e-6 on the card;
    # the NumPy oracle for MPC H=30)
    t0 = time.perf_counter()
    cbase = cfam.pack_theta(params=cprob.parameters())
    crefs, citers = dense_refs(
        cfam, np.vstack([cbase[None], ctheta[:N_REF_CHARGING]]), dev,
        shared=True)
    crefs_same, _ = dense_refs(cfam, ctheta[:N_REF_CHARGING], dev,
                               shared=True, eps_abs=cst.eps_abs,
                               eps_rel=cst.eps_rel,
                               check_interval=cst.check_interval)
    same_gap, _ = parity(crefs_same, crefs[1:])
    ptheta = charging_batch(cfam, cprob, B_CHARGING_PER, vary_gamma=True)
    prefs, piters = dense_refs(cfam, ptheta[:N_REF_CHARGING_PER], dev,
                               shared=False)
    mrefs = oracle_objs(mfam, mtheta, N_ORACLE_MPC30)
    print(f'# phase 9: references {time.perf_counter() - t0:.1f} s (dense '
          f'float64 ADMM iterations: shared {citers.tolist()}, per-instance '
          f'{piters.tolist()})')

    # 1-2: charging through generate_code -> solve(method='CPG') and
    # solve_batch at B=256; both launch K4
    k45.cr_solve.launches = 0
    code_dir = os.path.join(ROOT, 'build', 'chip_smoke', 'charging_code')
    cpg.generate_code(cprob, code_dir=code_dir, solver='BANDED',
                      solver_opts=CHARGING_SETTINGS, device=dev)
    t0 = time.perf_counter()
    val = cprob.solve(method='CPG')
    t_cpg = time.perf_counter() - t0
    cpg_launches = k45.cr_solve.launches
    rel = abs(val - crefs[0]) / max(1.0, abs(crefs[0]))
    print(f'# phase 9: charging T={CHARGING_T} solve(method=CPG): '
          f'{cprob.status}, objective {val:.6f} vs float64 {crefs[0]:.6f} '
          f'(rel {rel:.2e}), {cprob.solver_stats.num_iters} iters, '
          f'{1e3 * t_cpg:.1f} ms first call, K4 launches {cpg_launches} '
          f'[{card}]')
    check(cprob.status == 'optimal', f'charging CPG status {cprob.status}')
    check(rel <= PARITY_BAR, f'charging CPG objective rel {rel:.3e}')
    check(cpg_launches > 0, 'the charging CPG solve did not launch K4')
    out, dt, k4_launches, first = time_solve(csolver, ctheta, reps=2,
                                             counter=k45.cr_solve)
    obj = (out['obj'] + out['d']).double().cpu().numpy()
    gap, _ = parity(obj, crefs[1:])
    print(f'# phase 9: charging at eps {cst.eps_abs:g}: objective to the '
          f'eps 1e-6 float64 reference {gap:.3e}; the dense float64 ADMM at '
          f'eps {cst.eps_abs:g} is {same_gap:.3e} from it')
    gate_banded(f'charging T={CHARGING_T} shared P/A (K4 engine), parity '
                f'to the dense float64 ADMM at eps {cst.eps_abs:g}', out,
                crefs_same, dt, k4_launches, first, card, 'K4')
    check(k4_launches > 0, 'the charging path did not launch K4')
    tight = dataclasses.replace(cst, eps_abs=CHARGING_TIGHT_EPS,
                                eps_rel=CHARGING_TIGHT_EPS)
    out, dt, tight_launches, first = time_solve(
        csolver, ctheta, reps=1, counter=k45.cr_solve, settings=tight)
    gate_banded(f'charging T={CHARGING_T} shared P/A (K4 engine) at eps '
                f'{CHARGING_TIGHT_EPS:g}, parity to eps 1e-6', out,
                crefs[1:], dt, tight_launches, first, card, 'K4')
    kernel_share(csolver, ctheta, 'cr_solve', card)

    # 3: MPC H=30 through make_compiled_solver(fam, 'ADMM') -> K5
    out, dt, k5_launches, first = time_solve(
        msolver, mtheta, reps=3, counter=k45.banded_shared_chunk)
    gate_banded('MPC H=30 shared P/A (K5 engine)', out, mrefs, dt,
                k5_launches, first, card, 'K5')
    check(k5_launches > 0, 'the MPC H=30 path did not launch K5')
    kernel_share(msolver, mtheta, 'banded_shared_chunk', card)

    # 4: the per-instance engine (gamma varies, so P does): no kernel
    check(not csolver._use_shared(ptheta, 'auto'),
          'the per-instance charging batch would take the shared path')
    out, dt, _, first = time_solve(csolver, ptheta, reps=1)
    gate_banded(f'charging T={CHARGING_T} per-instance P', out, prefs, dt,
                0, first, card)
    return k4_numbers, k4_launches, k5_numbers, k5_launches


# ---------------------------------------------------------------------------
# phases 10-11: the conic interior-point path (kernels K6, K7, K8)
# ---------------------------------------------------------------------------

# bench.py:395-457, the entropy row: n = 32, B = 1024 distinct c ~ N(0, 1)
# from default_rng(5), the settings of bench.py:424-429 in float32
ENTROPY_N = 32
ENTROPY_N_LARGE = 64        # N = 321, Np = 336: K6's device-scratch path
B_ENTROPY = 1024
B_ENTROPY_LARGE = 64
ENTROPY_SETTINGS = dict(max_iter=60, tol_feas=1e-3, tol_gap=1e-3)
# bench.py:347-392, the ADP SOCP row: B = 1024, f scaled by U(0.5, 1.5)
# from default_rng(1), the settings of bench.py:368-371 in float32
B_ADP = 1024
ADP_SETTINGS = dict(max_iter=100, tol_feas=3e-5, tol_gap=3e-5)
N_ORACLE_ADP = 16
# K6 against its plain version on the IPM's K: L, d and Linv within
# LDL_TOL * max(1, |v|_inf) per instance (both factor the same float32 K in
# the same panel order; their dot products sum in other orders, and the
# unpivoted elimination carries that roundoff through the panels)
LDL_TOL = 1e-4
# K7's inverse and K8's solve, on one factor: their distance from the
# float64 application of that factor within twice their plain versions',
# plus this floor, by two measures (entry_errs)
LDL_APPLY_FLOOR = 1e-6
# the entropy batch (seed 5) through K6 + K8 with K8's first design (one
# block per instance, L read from device memory in both sweeps): mean and
# largest iterations, as ab_kernels.py k8 measured it on an H100 80GB HBM3
# at 700 W; phase 11 prints this run's beside them
K8_FIRST_DESIGN_ITERS = (13.1914, 20)


def entropy_problem(ct, n):
    x = ct.Variable(n, name='x')
    c = ct.Parameter(n, name='c')
    return ct.Problem(ct.Maximize(c @ x + ct.sum(ct.entr(x))),
                      [ct.sum(x) == 1.0]), c


def entropy_batch(fam, prob, cs):
    base = fam.pack_theta(params=prob.parameters())
    ci = [pi for pi in fam.param_info if pi.name == 'c'][0]
    theta = np.tile(base, (cs.shape[0], 1))
    theta[:, ci.offset:ci.offset + ci.flat_size] = cs
    return theta


def ldl_dims(N, p=16):
    nbp = -(-N // p)
    return nbp * p, nbp


def bound(ops, nbytes):
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def k6_bound(B, N, p=16):
    """The function's least work, not this kernel's: the lower triangle of
    the symmetric K in; L (B, Np, Np), d and Linv out, written in full as
    the contract's dense outputs; N^3 / 3 FLOP for the LDL^T and p^3 / 3
    per panel for its unit-lower inverse."""
    Np, nbp = ldl_dims(N, p)
    ops = B * (N ** 3 / 3 + nbp * p ** 3 / 3)
    nbytes = 4.0 * (B * (N * (N + 1) / 2 + Np * Np + Np + Np * p) + Np)
    return bound(ops, nbytes) + (ops, nbytes)


def _factor_words(N, p):
    """Floats of a factor that a use of it must read: the strictly lower
    triangle of L over the N unpadded rows (its diagonal is 1, its tail the
    identity), d, and the strictly lower triangles of the panel inverses."""
    nbp = ldl_dims(N, p)[1]
    return N * (N - 1) / 2 + N + nbp * p * (p - 1) / 2


def k7_bound(B, N, p=16):
    """The function's least work: the factor in, Kinv (B, N, N) out; the
    2 N^3 / 3 FLOP of an inverse from an LDL^T (L^-1, then the symmetric
    product L^-T D^-1 L^-1)."""
    ops = B * 2 * N ** 3 / 3
    nbytes = 4.0 * B * (_factor_words(N, p) + N * N)
    return bound(ops, nbytes) + (ops, nbytes)


def k8_bound(B, N, p=16):
    """The function's least work: the factor and b in, x out; two
    unit-triangular sweeps and the diagonal, 2 N^2 - N FLOP."""
    ops = B * (2 * N * N - N)
    nbytes = 4.0 * B * (_factor_words(N, p) + 2 * N)
    return bound(ops, nbytes) + (ops, nbytes)


class _Captured(Exception):
    pass


def capture_kkt(solver, theta, first_only=False):
    """The KKT matrices that the IPM's 'ldl' mode hands kernel K6 in one
    solve_batch: the first iteration's K, and each instance's K at its own
    last iteration (its worst-conditioned one; instances that finished are
    frozen and their later K never used), each with the signs and the
    pivot floor.  ``first_only`` stops the solve after the first."""
    from cvxpygen_tpu_torch.solvers import ipm as ipm_mod
    real = ipm_mod.ldl_factor_kernel
    seen = []

    def grab(K, signs, dyn_delta, panel=16):
        seen.append(K.clone())
        if first_only:
            raise _Captured()
        return real(K, signs, dyn_delta, panel)

    ipm_mod.ldl_factor_kernel = grab
    try:
        out = solver.solve_batch(theta)
        last = torch.stack([seen[int(t) - 1][i] for i, t in
                            enumerate(out['iters'].tolist())])
    except _Captured:
        last = None
    finally:
        ipm_mod.ldl_factor_kernel = real
    return seen[0], last


def inst_err(a, b):
    """Per-instance max |a - b| / max(1, |b|_inf) (leading axis = batch)."""
    a = a.double().flatten(1)
    b = b.double().flatten(1)
    den = torch.clamp(b.abs().amax(dim=1), min=1.0)
    return (a - b).abs().amax(dim=1) / den


def entry_errs(a, e):
    """Two per-instance errors of ``a`` against ``e``, worst instance: the
    largest |a - e| / max(1, |e|_inf), and the median over entries of
    |a - e| / |e| (entries with e != 0), which the few large entries of an
    ill-conditioned K cannot hide."""
    a = a.double().flatten(1)
    e = e.double().flatten(1)
    rel = torch.where(e != 0, (a - e).abs() / e.abs(),
                      torch.full_like(e, float('nan')))
    return (float(inst_err(a, e).max()),
            float(rel.nanmedian(dim=1).values.max()))


def compare_ldl(K, signs, dd, label, factor_tol=LDL_TOL):
    """K6 against its plain version on one KKT batch: L, d and Linv within
    ``factor_tol`` * max(1, |v|_inf) per instance; with ``factor_tol``
    None, both factors held to the float64 factor of the same K instead,
    by the rule below.  Then K7's inverse and K8's x of a random b, from K6's
    factor (K8 in each layout that fits, k8_layouts), each beside its plain
    version on the same factor, both held to the float64 application of that
    factor: the kernel's error within twice the plain version's plus
    LDL_APPLY_FLOOR, by both measures of entry_errs.  (The IPM's K has pivots
    at the regularization floor, so float32 roundoff is amplified by cond(K');
    two float32 results then differ by far more than LDL_TOL, and float64 shows
    which of the two is closer.)  Returns the factor's worst relative distance
    to its plain version and, per held output, its errors and its distance to
    its plain version."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    check(bool(torch.isfinite(K).all()), f'{label}: non-finite K')
    with full_f32_matmul():
        fac = lk.ldl_factor_kernel(K, signs, dd)
        ref = lk.ldl_factor_plain(K, signs, dd)
        errs = {k: inst_err(fac[k], ref[k]) for k in ('L', 'd', 'Linv')}
        held = {}
        if factor_tol is None:
            ref64 = lk.ldl_factor_plain(K.double(), signs, dd)
            for k in ('L', 'd', 'Linv'):
                held[k] = (entry_errs(fac[k], ref64[k]),
                           entry_errs(ref[k], ref64[k]),
                           float(errs[k].max()))
        b = torch.randn(K.shape[:2], generator=torch.Generator(
            device=K.device).manual_seed(0), device=K.device)
        fac64 = dict(fac, **{k: fac[k].double() for k in ('L', 'd', 'Linv')})
        for name, kern, plain, exact in (
                ('Kinv', lk.ldl_inverse_kernel(fac),
                 lk.ldl_inverse_plain(fac), lk.ldl_inverse_plain(fac64)),
                ('x', lk.ldl_solve_kernel(fac, b), lk.ldl_solve_plain(fac, b),
                 lk.ldl_solve_plain(fac64, b.double()))):
            held[name] = (entry_errs(kern, exact), entry_errs(plain, exact),
                          float(inst_err(kern, plain).max()))
        held_solve = k8_layouts(fac, b, fac64, label)
    torch.cuda.synchronize()
    worst = {k: float(v.max()) for k, v in errs.items()}
    print(f'# phase 10: {label}: B={K.shape[0]}, N={K.shape[1]}, '
          f'Np={fac["Np"]}: K6 to its plain version, max |d| / max(1, '
          f'|v|_inf) per instance '
          + ', '.join(f'{k} {v:.3e}' for k, v in worst.items())
          + '; kernel / plain against float64 (the factor of K; the '
          'application of K6\'s factor), max |d| / max(1, |v|_inf) and '
          'median entry |d| / |v|, worst instance (kernel to plain): '
          + ', '.join(f'{k} {a[0]:.3e} / {b[0]:.3e} and {a[1]:.3e} / '
                      f'{b[1]:.3e} ({c:.3e})'
                      for k, (a, b, c) in held.items()))
    if factor_tol is not None:
        for k, v in worst.items():
            check(v <= factor_tol,
                  f'{label}: {k} differs by {v:.3e} > {factor_tol}')
    for k, (ek, ep, _) in list(held.items()) + list(held_solve.items()):
        for what, a, b in zip(('max', 'median entry'), ek, ep):
            check(a <= 2 * b + LDL_APPLY_FLOOR, f'{label}: {k} {what} error '
                  f'{a:.3e} > 2 x plain {b:.3e} + {LDL_APPLY_FLOOR}')
    return max(worst.values()), held


def k8_layouts(fac, b, fac64, label, tol=None):
    """K8 in each layout that fits this factor (resident at p = 16 up to
    Np = 320, streamed always; ops/ldl_kernel.py::solve_plan) on b: x
    against the plain version on the same factor (within ``tol`` * max(1,
    |x|_inf) per instance unless ``tol`` is None), a second call bitwise
    equal, and the shared-memory rule held to the library's.  Returns per
    layout the errors of x and of the plain version against the float64
    application of the factor, for compare_ldl's rule, and the distance to
    the plain version."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    N = b.shape[1]
    plan = lk.solve_plan(N)
    plain = lk.ldl_solve_plain(fac, b)
    exact = lk.ldl_solve_plain(fac64, b.double())
    ep = entry_errs(plain, exact)
    out = {}
    for lay in range(plan['layout_id'], len(lk.SOLVE_LAYOUTS)):
        name = lk.SOLVE_LAYOUTS[lay]
        xk = lk._solve_launch(fac, b, lay)
        same = torch.equal(lk._solve_launch(fac, b, lay), xk)
        err = float(inst_err(xk, plain).max())
        out[f'x ({name} K8)'] = (entry_errs(xk, exact), ep, err)
        print(f'# phase 10: {label}: K8 {name} layout (plan: '
              f'{plan["layout"]}): max |d| / max(1, |x|_inf) to its plain '
              f'version {err:.3e}' + ('' if tol is None else f' (bar {tol})')
              + f'; a second call bitwise equal {same}')
        check(same, f'{label}: K8 {name} is not deterministic')
        check(tol is None or err <= tol, f'{label}: K8 {name} differs from '
              f'its plain version by {err:.3e} > {tol}')
        check(lk._LIB_SOLVE.ldl_solve_smem_bytes(plan['Np'], plan['p'],
                                                 int(lay == 0))
              == lk.solve_smem_bytes(N, lay, plan['p']),
              f'K8 shared-memory rule at N={N}, {name}')
    return out


def k8_well_conditioned(shapes=((161, 256), (321, 64))):
    """K8 on K6's factor of phase 10's well-conditioned quasidefinite K at
    the entropy shape (N=161: both layouts) and its n=64 twin's (N=321:
    streamed), each layout within LDL_TOL * max(1, |x|_inf) per instance
    of its plain version.  (On the IPM's own K, whose pivots sit at the
    regularization floor, any two float32 orders of the solve differ by
    far more than LDL_TOL, the first design's too: compare_ldl holds K8
    there to the float64 application of the factor.)"""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    g = torch.Generator(device='cuda').manual_seed(4)
    for N, B in shapes:
        K, signs = well_conditioned_large(N, B, g)
        with full_f32_matmul():
            fac = lk.ldl_factor_kernel(K, signs, 1e-4)
            b = torch.randn((B, N), generator=g, device='cuda')
            fac64 = dict(fac, **{k: fac[k].double()
                                 for k in ('L', 'd', 'Linv')})
            k8_layouts(fac, b, fac64, f'well-conditioned K, N={N}, B={B}',
                       LDL_TOL)


def k7_large_batch(B=70000, n=3, m=4):
    """K7 at a batch above 65535 (the grid.y limit of its first design; its
    one-dimensional grid takes the batch in one launch): a small
    well-conditioned quasidefinite K (N=7), its inverse within LDL_TOL *
    max(1, |v|_inf) of the plain version's."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    g = torch.Generator(device='cuda').manual_seed(2)
    A = torch.randn((B, n, n), generator=g, device='cuda')
    C = torch.randn((B, m, n), generator=g, device='cuda')
    K = torch.zeros((B, n + m, n + m), device='cuda')
    K[:, :n, :n] = A @ A.transpose(1, 2) + torch.eye(n, device='cuda')
    K[:, n:, :n] = C
    K[:, :n, n:] = C.transpose(1, 2)
    K[:, n:, n:] = -torch.eye(m, device='cuda')
    signs = np.concatenate([np.ones(n), -np.ones(m)])
    with full_f32_matmul():
        fac = lk.ldl_factor_kernel(K, signs, 1e-4)
        before = lk.ldl_inverse_kernel.launches
        Kinv = lk.ldl_inverse_kernel(fac)
        launches = lk.ldl_inverse_kernel.launches - before
        err = float(inst_err(Kinv, lk.ldl_inverse_plain(fac)).max())
    print(f'# phase 10: K7 at B={B} ({launches} launches), N={n + m}: max '
          f'|d| / max(1, |v|_inf) to its plain version {err:.3e}')
    check(launches == 1, f'K7 at B={B}: {launches} launches')
    check(err <= LDL_TOL, f'K7 at B={B}: {err:.3e} > {LDL_TOL}')


def well_conditioned_large(N, B, g):
    """A well-conditioned quasidefinite K ([[A A' / n + I, C' / sqrt(n)],
    [C / sqrt(n), -I]], n = N // 2) from the generator g on the card, and
    its pivot signs."""
    n, m = N // 2, N - N // 2
    A = torch.randn((B, n, n), generator=g, device='cuda')
    C = torch.randn((B, m, n), generator=g, device='cuda') / n ** 0.5
    K = torch.zeros((B, N, N), device='cuda')
    K[:, :n, :n] = A @ A.transpose(1, 2) / n + torch.eye(n, device='cuda')
    K[:, n:, :n] = C
    K[:, :n, n:] = C.transpose(1, 2)
    K[:, n:, n:] = -torch.eye(m, device='cuda')
    return K, np.concatenate([np.ones(n), -np.ones(m)])


def k7_large_n(card, Ns=(801, 1601), B=4):
    """K7 where a stage could not hold a panel's whole block of L (N=801:
    L applied in chunks of 256 rows, R resident) and where R does not fit
    shared memory (N=1601: R in the device scratch): a well-conditioned
    quasidefinite K ([[A A' / n + I, C' / sqrt(n)], [C / sqrt(n), -I]]),
    K6's factor, the inverse within LDL_TOL * max(1, |v|_inf) per instance
    of the plain version's on that factor; kernel and plain times."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    g = torch.Generator(device='cuda').manual_seed(3)
    for N in Ns:
        K, signs = well_conditioned_large(N, B, g)
        plan = lk.inverse_plan(N)
        with full_f32_matmul():
            fac = lk.ldl_factor_kernel(K, signs, 1e-4)
            Kinv = lk.ldl_inverse_kernel(fac)
            ref = lk.ldl_inverse_plain(fac)
            err = float(inst_err(Kinv, ref).max())
            ms = cuda_ms(lambda: lk.ldl_inverse_kernel(fac), 3)[0]
            plain_ms = cuda_ms(lambda: lk.ldl_inverse_plain(fac), 1)[0]
        print(f'# phase 10: K7 at N={N}, B={B} (plan: width {plan["width"]}, '
              f'R {"resident" if plan["resident"] else "in the device scratch"}'
              f', {plan["smem_bytes"]} B of shared memory): max |d| / max(1, '
              f'|v|_inf) to its plain version {err:.3e}; {ms:.4f} ms, plain '
              f'{plain_ms:.4f} ms [{card}]')
        check(bool(torch.isfinite(Kinv).all()), f'K7 at N={N}: non-finite')
        check(err <= LDL_TOL, f'K7 at N={N}: {err:.3e} > {LDL_TOL}')
        check(lk._LIB_INVERSE.ldl_inverse_smem_bytes(
            plan['Np'], plan['p'], plan['width'], int(plan['resident']))
              == plan['smem_bytes'], f'K7 shared-memory rule at N={N}')
    check(lk.inverse_plan(Ns[0])['resident']
          and not lk.inverse_plan(Ns[-1])['resident'],
          'K7: R resident at N=801, in the device scratch at 1601')


def k7_widths(K, signs, dd, card, label):
    """K7's plan on K6's factor of K, and its time at each column-tile
    width (CUDA events): every width bitwise equal to the plan's on the
    lower triangle, and its whole Kinv within twice the plain version's
    distance from the float64 application of the factor plus
    LDL_APPLY_FLOOR, by both measures of entry_errs (compare_ldl's
    rule)."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    B, N, _ = K.shape
    with full_f32_matmul():
        fac = lk.ldl_factor_kernel(K, signs, dd)
        fac64 = dict(fac, **{k: fac[k].double() for k in ('L', 'd', 'Linv')})
        exact = lk.ldl_inverse_plain(fac64)
        ep = entry_errs(lk.ldl_inverse_plain(fac), exact)
    del fac64
    plan = lk.inverse_plan(N)
    first = lk.ldl_inverse_kernel(fac)
    lower = torch.tril(torch.ones(N, N, dtype=torch.bool, device=K.device))
    line = []
    for w in (16, 32):
        out = lk._inverse_launch(fac, w)
        check(torch.equal(out[:, lower], first[:, lower]),
              f'K7 {label}: width {w} differs on the lower triangle')
        ek = entry_errs(out, exact)
        for what, a, b in zip(('max', 'median entry'), ek, ep):
            check(a <= 2 * b + LDL_APPLY_FLOOR, f'K7 {label}, width {w}: '
                  f'{what} error {a:.3e} > 2 x plain {b:.3e} + '
                  f'{LDL_APPLY_FLOOR}')
        ms, _ = cuda_ms(lambda: lk._inverse_launch(fac, w), 10)
        line.append(f'{w}: {ms:.4f} ms '
                    f'({lk.inverse_plan(N, width=w)["smem_bytes"]} B; '
                    f'against float64 {ek[0]:.3e} and {ek[1]:.3e})')
    print(f'# phase 10: K7 {label}, B={B}, N={N} (plan: width '
          f'{plan["width"]}, {plan["tiles"]} tiles per instance, '
          f'{plan["smem_bytes"]} B of shared memory), by tile width: '
          + ', '.join(line) + f' (plain against float64 {ep[0]:.3e} and '
          f'{ep[1]:.3e}); the lower triangle bitwise equal across widths '
          f'[{card}]')
    check(lk._LIB_INVERSE.ldl_inverse_smem_bytes(
        plan['Np'], plan['p'], plan['width'], int(plan['resident']))
          == plan['smem_bytes'], f'K7 shared-memory rule at N={N}')


def time_k8_layouts(K, signs, dd, card, label):
    """K8's time in each layout that fits K6's factor of K (CUDA events),
    with the bound."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    B, N, _ = K.shape
    fac = lk.ldl_factor_kernel(K, signs, dd)
    b = torch.randn((B, N), device=K.device)
    plan = lk.solve_plan(N)
    line = []
    for lay in range(plan['layout_id'], len(lk.SOLVE_LAYOUTS)):
        ms = cuda_ms(lambda: lk._solve_launch(fac, b, lay), 20)[0]
        line.append(f'{lk.SOLVE_LAYOUTS[lay]} {ms:.4f} ms')
    bound_ms, bound_by, _, _ = k8_bound(B, N)
    print(f'# phase 10: K8 {label}, B={B}, N={N} (plan: {plan["layout"]}, '
          f'{plan["smem_bytes"]} B of shared memory, {plan["threads"]} '
          f'threads, {plan["blocks_per_sm"]} blocks per SM), by layout: '
          + ', '.join(line) + f'; bound {bound_ms:.5f} ms ({bound_by}) '
          f'[{card}]')


def time_ldl(K, signs, dd, card):
    """Kernel, plain and library times of K6, K7 and K8 at the main shapes
    (CUDA events), with the bounds."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    B, N, _ = K.shape
    fac = lk.ldl_factor_kernel(K, signs, dd)
    ref = lk.ldl_factor_plain(K, signs, dd)
    b = torch.randn((B, N), device=K.device)
    out = {}
    k6 = (cuda_ms(lambda: lk.ldl_factor_kernel(K, signs, dd), 10)[0],
          cuda_ms(lambda: lk.ldl_factor_plain(K, signs, dd), 2)[0])
    k7 = (cuda_ms(lambda: lk.ldl_inverse_kernel(fac), 10)[0],
          cuda_ms(lambda: lk.ldl_inverse_plain(ref), 2)[0])
    k8 = (cuda_ms(lambda: lk.ldl_solve_kernel(fac, b), 20)[0],
          cuda_ms(lambda: lk.ldl_solve_plain(ref, b), 2)[0])
    # library yardsticks (timed here, used nowhere in the port): the
    # pivoted LDL of the same K, the inverse from K, the pivoted solve;
    # each called once before its timing, since its first call sets up
    # the library's handles and workspace
    LD, piv = torch.linalg.ldl_factor(K)
    torch.linalg.inv(K)
    torch.linalg.ldl_solve(LD, piv, b[..., None])
    lib = (cuda_ms(lambda: torch.linalg.ldl_factor(K), 2)[0],
           cuda_ms(lambda: torch.linalg.inv(K), 3)[0],
           cuda_ms(lambda: torch.linalg.ldl_solve(LD, piv, b[..., None]),
                   3)[0])
    for name, (ms, plain_ms), lib_ms, bfn in (
            ('ldl_factor', k6, lib[0], k6_bound),
            ('ldl_inverse', k7, lib[1], k7_bound),
            ('ldl_solve', k8, lib[2], k8_bound)):
        bound_ms, bound_by, ops, nbytes = bfn(B, N)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=lib_ms)
        print(f'# phase 10: {name} at B={B}, N={N}: kernel {ms:.4f} ms, '
              f'plain {plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound '
              f'{bound_ms:.5f} ms ({bound_by}; {ops / 1e9:.2f} GFLOP FP32, '
              f'{nbytes / 1e6:.1f} MB) [{card}]')
    return out


def ldl_share(solver, theta, card):
    """One more entropy solve with CUDA events around each launch of K6 and
    K7: their summed device time against the solve's wall time."""
    from cvxpygen_tpu_torch.solvers import ipm as ipm_mod
    names = ('ldl_factor_kernel', 'ldl_inverse_kernel')
    reals = {n: getattr(ipm_mod, n) for n in names}
    events = {n: [] for n in names}

    def timed(name):
        def fn(*args, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = reals[name](*args, **kw)
            ev[1].record()
            events[name].append(ev)
            return out
        return fn

    for n in names:
        setattr(ipm_mod, n, timed(n))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve_batch(theta)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    finally:
        for n in names:
            setattr(ipm_mod, n, reals[n])
    ks = {n: sum(a.elapsed_time(b) for a, b in evs)
          for n, evs in events.items()}
    rest = wall - sum(ks.values())
    print(f'# phase 11: where the time goes, entropy B={theta.shape[0]}: '
          f'{wall:.3f} ms per batch, of which K6 {ks[names[0]]:.3f} ms and '
          f'K7 {ks[names[1]]:.3f} ms in {len(events[names[0]])} launches '
          f'each (CUDA events), the rest {rest:.3f} ms (KKT assembly, '
          f'cone scalings, line searches, checks and host) [{card}]')


def gate_conic(name, out, refs, dt, launches, card, maximize=False,
               phase='phase 11'):
    """Every instance solved, finite, within the parity bar of its
    reference; prints solves/s, mean iterations and the launches."""
    B = out['status'].shape[0]
    frac = float(np.mean(out['status'].cpu().numpy() == 1))
    obj = (out['obj'] + out['d']).double().cpu().numpy()
    if maximize:
        obj = -obj
    max_rel, n_bad = parity(obj, refs)
    iters = out['iters'].float()
    print(f'# {phase}: {name}, B={B}: frac_solved {frac}, mean iters '
          f'{float(iters.mean()):.2f} (max {int(iters.max())}), '
          f'{B / dt:.1f} solves/s, {1e3 * dt:.3f} ms per batch, launches '
          f'{launches}; parity on {len(refs)}: max rel {max_rel:.3e} '
          f'({n_bad} non-finite) [{card}]')
    check(bool(np.all(np.isfinite(out['x'].cpu().numpy()))),
          f'{name}: non-finite x')
    check(frac == 1.0, f'{name}: frac_solved {frac} < 1')
    check(n_bad == 0 and max_rel <= PARITY_BAR,
          f'{name}: parity {max_rel:.3e} ({n_bad} non-finite)')


def phase_conic(card, dev='cuda'):
    """Phases 10-12: K6-K8 against their plain versions on the entropy
    family's KKT matrices, the conic IPM main path at full width, then the
    fused routes (phase_fused).  Returns K6-K8's numbers and launches, then
    K9's and K10's."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch import cpg
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    from cvxpygen_tpu_torch.ops.ldl_batched import default_delta
    from cvxpygen_tpu_torch.runtime.solver import CompiledConicSolver
    from cvxpygen_tpu_torch.solvers.ipm import IPMSettings

    # the entropy family at n = 32 (N = 161, Np = 176) and n = 64
    eprob, ec = entropy_problem(ct, ENTROPY_N)
    cs = np.random.default_rng(5).normal(size=(B_ENTROPY, ENTROPY_N))
    ec.value = cs[0]
    efam = canonicalize(eprob)
    etheta = entropy_batch(efam, eprob, cs)
    lse = list(np.log(np.sum(np.exp(cs), axis=1)))
    est = IPMSettings.for_dtype(torch.float32, **ENTROPY_SETTINGS)
    esolver = CompiledConicSolver(efam, settings=est, dtype=torch.float32,
                                  device=dev)
    check(esolver.jf.maps.dtype == torch.float32, 'float32 on the card')
    check(esolver.P_is_zero, 'entropy: P != 0')
    lprob, lc = entropy_problem(ct, ENTROPY_N_LARGE)
    lcs = np.random.default_rng(6).normal(size=(B_ENTROPY_LARGE,
                                                ENTROPY_N_LARGE))
    lc.value = lcs[0]
    lfam = canonicalize(lprob)
    lsolver = CompiledConicSolver(lfam, settings=est, dtype=torch.float32,
                                  device=dev)

    # phase 10: the kernels on the KKT matrices of the entropy solve
    t0 = time.perf_counter()
    K0, K1 = capture_kkt(esolver, etheta)
    KL, _ = capture_kkt(lsolver, entropy_batch(lfam, lprob, lcs),
                        first_only=True)
    # the IPM's 'ldl' pivot signs (+1 on x, -1 on the zero and cone rows)
    # and pivot floor
    s0 = np.concatenate([np.ones(efam.n), -np.ones(efam.m)])
    sL = np.concatenate([np.ones(lfam.n), -np.ones(lfam.m)])
    dd = default_delta(torch.float32)
    print(f'# phase 10: entropy n={ENTROPY_N}: canonical n={efam.n}, '
          f'mz={efam.n_zero}, {efam.n_exp} exp cones, KKT N={K0.shape[1]}; '
          f'n={ENTROPY_N_LARGE}: N={KL.shape[1]}; captured in '
          f'{time.perf_counter() - t0:.1f} s')
    check(ldl_dims(K0.shape[1])[0] == 176 and ldl_dims(KL.shape[1])[0] == 336,
          'entropy KKT shapes')
    err_first, apply_first = compare_ldl(K0, s0, dd,
                                         'first iteration, Np=176')
    compare_ldl(KL, sL, dd, 'first iteration, Np=336 (device scratch)')
    for N in (K0.shape[1], KL.shape[1]):
        lay = lk.factor_layout(N)
        check(lk._LIB_FACTOR.ldl_factor_smem_bytes(lay['Np'], lay['p'])
              == lay['smem_bytes'], f'K6 storage rule at N={N}')
    check(lk.factor_layout(K0.shape[1])['resident']
          and not lk.factor_layout(KL.shape[1])['resident'],
          'K6: tiles in shared memory at Np=176, a device scratch at 336')
    # the last K: the two float32 factors differ by up to about 5e-4 (d)
    # there, so both are held to the float64 factor
    compare_ldl(K1, s0, dd, "each instance's last iteration, Np=176",
                factor_tol=None)
    k8_well_conditioned()
    k7_large_batch()
    k7_large_n(card)
    k7_widths(K0, s0, dd, card, 'first iteration')
    k7_widths(KL, sL, dd, card, 'n=64 twin')
    time_k8_layouts(K0, s0, dd, card, 'first iteration')
    time_k8_layouts(KL, sL, dd, card, 'n=64 twin')
    numbers = time_ldl(K0, s0, dd, card)
    # max_abs_err: K6 to its plain version; K7 and K8 to theirs (both
    # relative to max(1, |v|_inf) per instance, the first iteration's K)
    numbers['ldl_factor']['max_abs_err'] = err_first
    numbers['ldl_inverse']['max_abs_err'] = apply_first['Kinv'][2]
    numbers['ldl_solve']['max_abs_err'] = apply_first['x'][2]

    # phase 11: the main path at full width
    launches = {}
    default_out = None
    for label, st in (('K6 + K7', est),
                      ('K6 + K8', dataclasses.replace(est,
                                                      ldl_inverse=False))):
        lk.ldl_factor_kernel.launches = 0
        lk.ldl_inverse_kernel.launches = 0
        lk.ldl_solve_kernel.launches = 0
        out = esolver.solve_batch(etheta, settings=st)
        counts = (lk.ldl_factor_kernel.launches,
                  lk.ldl_inverse_kernel.launches,
                  lk.ldl_solve_kernel.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            out = esolver.solve_batch(etheta, settings=st)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / reps
        gate_conic(f'entropy n={ENTROPY_N} through {label}', out, lse, dt,
                   f'K6 {counts[0]}, K7 {counts[1]}, K8 {counts[2]}', card,
                   maximize=True)
        check(counts[0] > 0, f'{label}: K6 was not launched')
        if st.ldl_inverse:
            check(counts[1] > 0 and counts[2] == 0, f'{label}: launches')
            launches['ldl_factor'] = counts[0]
            launches['ldl_inverse'] = counts[1]
            default_out = out
        else:
            check(counts[2] > 0 and counts[1] == 0, f'{label}: launches')
            launches['ldl_solve'] = counts[2]
            iters = out['iters'].float()
            print(f'# phase 11: entropy through K6 + K8: mean iters '
                  f'{float(iters.mean()):.4f} (max {int(iters.max())}); '
                  f'with K8\'s first design '
                  f'{K8_FIRST_DESIGN_ITERS[0]} (max '
                  f'{K8_FIRST_DESIGN_ITERS[1]})')
    ldl_share(esolver, etheta, card)

    # one entropy instance through generate_code(solver='CLARABEL')
    code_dir = os.path.join(ROOT, 'build', 'chip_smoke', 'entropy_code')
    cpg.generate_code(eprob, code_dir=code_dir, solver='CLARABEL', device=dev)
    lk.ldl_factor_kernel.launches = 0
    t0 = time.perf_counter()
    val = eprob.solve(method='CPG')
    t_cpg = time.perf_counter() - t0
    rel = abs(val - lse[0]) / max(1.0, abs(lse[0]))
    print(f'# phase 11: entropy solve(method=CPG), solver CLARABEL: '
          f'{eprob.status}, objective {val:.6f} vs logsumexp(c) {lse[0]:.6f} '
          f'(rel {rel:.2e}), {eprob.solver_stats.num_iters} iters, '
          f'{1e3 * t_cpg:.1f} ms first call, K6 launches '
          f'{lk.ldl_factor_kernel.launches} [{card}]')
    check(eprob.status == 'optimal', f'entropy CPG status {eprob.status}')
    check(rel <= PARITY_BAR, f'entropy CPG objective rel {rel:.3e}')
    check(lk.ldl_factor_kernel.launches > 0, 'entropy CPG: K6 not launched')

    # the ADP SOCP family through the default generate_code route (IPM)
    aprob = assign_adp(adp_problem(ct))
    code_dir = os.path.join(ROOT, 'build', 'chip_smoke', 'adp_code')
    mod = cpg.generate_code(aprob, code_dir=code_dir, device=dev)
    asolver = mod._runtime.solver
    check(asolver.solver_name == 'IPM', f'ADP routes to '
          f'{asolver.solver_name}')
    val = aprob.solve(method='CPG')
    check(aprob.status == 'optimal', f'ADP CPG status {aprob.status}')
    afam = asolver.family
    atheta = adp_batch(afam, aprob, B_ADP)
    ast = IPMSettings.for_dtype(torch.float32, **ADP_SETTINGS)
    out = asolver.solve_batch(atheta, settings=ast)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        out = asolver.solve_batch(atheta, settings=ast)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    arefs = oracle_objs(afam, atheta, N_ORACLE_ADP)
    gate_conic(f'ADP SOCP (generate_code default: IPM, schur mode; CPG '
               f'{val:.6f})', out, arefs, dt, 'none (no kernel)', card)
    # the same batch through the two-level 'ldl' route: K6 and K7 on the
    # saddle block [[P, -E'], [-E, -reg I]] once, then on the Schur
    # complement S = H + C' Ktop^-1 C (signs all +1) every iteration.  (On
    # the entropy family in float32 this route stalls in the plain version
    # too: with P = 0 the saddle block's primal pivots are static_reg.)
    tst = dataclasses.replace(ast, kkt_solver='ldl', ldl_two_level=True)
    for kern in (lk.ldl_factor_kernel, lk.ldl_inverse_kernel,
                 lk.ldl_solve_kernel):
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = asolver.solve_batch(atheta, settings=tst)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = (lk.ldl_factor_kernel.launches, lk.ldl_inverse_kernel.launches,
              lk.ldl_solve_kernel.launches)
    gate_conic('ADP SOCP through the two-level ldl route (one call)', out,
               arefs, dt, f'K6 {counts[0]}, K7 {counts[1]}, K8 {counts[2]}',
               card)
    check(counts[1] == counts[0] > 1 and counts[2] == 0,
          f'two-level launches {counts}')
    fused_numbers, fused_launches = phase_fused(
        card, (K0, s0), (KL, sL), dd, esolver, etheta, est, lse,
        (default_out, launches['ldl_factor']), asolver, atheta, tst, arefs,
        out)
    return numbers, launches, fused_numbers, fused_launches


# ---------------------------------------------------------------------------
# phase 12: the fused LDL factor + inverse routes (kernels K9 and K10)
# ---------------------------------------------------------------------------

# a well-conditioned K (tests/test_ldl.py's construction, n=10, mc=14:
# N=24) held to its float64 inverse at this bar, relative to max(1, |v|)
FUSED_WELL_TOL = 1e-5
B_FUSED_WELL = 64


def fused_bound(B, N):
    """The function's least work for K9 and K10 (the same function): the
    lower triangle of the symmetric K in, Kinv (B, N, N) out; N^3 FLOP per
    instance (N^3 / 3 for the LDL^T, 2 N^3 / 3 for the inverse from it)."""
    ops = float(B) * N ** 3
    nbytes = 4.0 * B * (N * (N + 1) / 2 + N * N)
    return bound(ops, nbytes) + (ops, nbytes)


# (name, tag, wrapper, plain version, the variable that routes the IPM to
# it); both wrappers launch the one fused kernel, csrc/ldl_kinv.cu
FUSED = (('ldl_factor_inverse', 'K9', 'ldl_factor_inverse_kernel',
          'ldl_factor_inverse_plain', 'CPG_LDL_FUSED'),
         ('ldl_kinv', 'K10', 'ldl_kinv_kernel', 'ldl_kinv_plain',
          'CPG_LDL_BM_FUSED'))


@contextlib.contextmanager
def env_set(name, value):
    """``name=value`` in the environment for the block, restored after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


def well_conditioned_kkt(B, dev, n=10, mc=14, seed=11):
    """tests/test_ldl.py's quasidefinite [[I, -G'], [-G, -H]], float64."""
    f64 = dict(device=dev, dtype=torch.float64)
    g = torch.Generator(device=dev).manual_seed(seed)
    G = torch.randn((B, mc, n), generator=g, **f64)
    Hs = 0.3 * torch.randn((B, mc, mc), generator=g, **f64)
    K = torch.zeros((B, n + mc, n + mc), **f64)
    K[:, :n, :n] = torch.eye(n, **f64)
    K[:, :n, n:] = -G.transpose(1, 2)
    K[:, n:, :n] = -G
    K[:, n:, n:] = -(Hs @ Hs.transpose(1, 2) + torch.eye(mc, **f64))
    return K, np.concatenate([np.ones(n), -np.ones(mc)])


def fused_bitwise(K, signs, dd, label):
    """K9 and K10 on K against K7 on K6's factor of K: bitwise equal, both
    triangles; the fused kernel's layout rule (kinv_layout) held to the
    library's.  Returns K6 + K7's Kinv and each wrapper's."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    B, N, _ = K.shape
    k67 = lk.ldl_inverse_kernel(lk.ldl_factor_kernel(K, signs, dd))
    outs = {}
    for name, tag, kname, _, _ in FUSED:
        out = getattr(lk, kname)(K, signs, dd)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f'{tag} at {label}: '
              'non-finite Kinv')
        check(torch.equal(out, k67), f'{tag} at {label}: '
              f'{int((out != k67).sum())} entries differ from K6 + K7')
        outs[name] = out
    lay = lk.kinv_layout(N)
    check(lk._LIB_KINV.ldl_kinv_smem_bytes(lay['Np'], lay['p'], lay['width'],
                                           lay['layout_id'])
          == lay['smem_bytes']
          and lk._LIB_KINV.ldl_kinv_scratch_words(
              lay['Np'], lay['p'], lay['width'], lay['layout_id'])
          == lay['scratch_words'], f'fused layout rule at N={N}')
    print(f'# phase 12: K9 and K10 at {label} (layout {lay["layout"]}, '
          f'{lay["smem_bytes"]} B of shared memory, {lay["blocks_per_sm"]} '
          'blocks per SM): bitwise equal to K7 on K6\'s factor, both '
          'triangles')
    return k67, outs


def compare_fused(K, signs, dd, card):
    """K9 and K10 on the entropy family's first-iteration K: bitwise equal
    to K6 + K7 (fused_bitwise); each held to the float64 inverse of the
    pivot-regularized K (its plain version in float64): within twice the
    float32 plain version's distance plus LDL_APPLY_FLOOR, by both measures
    of entry_errs (phase 10's rule for K7); then both on a well-conditioned
    K within FUSED_WELL_TOL of its float64 inverse; then their times beside
    K6's and K7's, the plain versions' and torch.linalg.inv(K)'s.  Returns
    each kernel's numbers."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    B, N, _ = K.shape
    numbers = {}
    with full_f32_matmul():
        k67, outs = fused_bitwise(K, signs, dd, f'the first-iteration K '
                                  f'(N={N}, B={B})')
        Kw, sw = well_conditioned_kkt(B_FUSED_WELL, K.device)
        for name, tag, kname, pname, _ in FUSED:
            kern, plain = getattr(lk, kname), getattr(lk, pname)
            out = outs[name]
            ref = plain(K, signs, dd)
            exact = plain(K.double(), signs, dd)
            ek, ep = entry_errs(out, exact), entry_errs(ref, exact)
            e67 = entry_errs(k67, exact)
            to_plain = float(inst_err(out, ref).max())
            well = float(inst_err(kern(Kw.float(), sw, dd),
                                  plain(Kw, sw, dd)).max())
            print(f'# phase 12: {tag} ({name}) on the first-iteration K, '
                  f'B={B}, N={N}: against the float64 inverse, max |d| / '
                  f'max(1, |v|_inf) and median entry |d| / |v|, worst '
                  f'instance: kernel {ek[0]:.3e} and {ek[1]:.3e}, plain '
                  f'{ep[0]:.3e} and {ep[1]:.3e}, K6 + K7 {e67[0]:.3e} and '
                  f'{e67[1]:.3e}; kernel to '
                  f'plain {to_plain:.3e}; well-conditioned N=24, '
                  f'B={B_FUSED_WELL}: {well:.3e} (bar {FUSED_WELL_TOL})')
            for what, a, b in zip(('max', 'median entry'), ek, ep):
                check(a <= 2 * b + LDL_APPLY_FLOOR, f'{tag}: {what} error '
                      f'{a:.3e} > 2 x plain {b:.3e} + {LDL_APPLY_FLOOR}')
            check(well <= FUSED_WELL_TOL,
                  f'{tag}: well-conditioned K {well:.3e} > {FUSED_WELL_TOL}')
            numbers[name] = dict(max_abs_err=to_plain)
    fac = lk.ldl_factor_kernel(K, signs, dd)
    k6_ms = cuda_ms(lambda: lk.ldl_factor_kernel(K, signs, dd), 10)[0]
    k7_ms = cuda_ms(lambda: lk.ldl_inverse_kernel(fac), 10)[0]
    torch.linalg.inv(K)                   # its first call sets up cuSOLVER
    lib_ms = cuda_ms(lambda: torch.linalg.inv(K), 3)[0]
    bound_ms, bound_by, ops, nbytes = fused_bound(B, N)
    for name, tag, kname, pname, _ in FUSED:
        kern, plain = getattr(lk, kname), getattr(lk, pname)
        ms = cuda_ms(lambda: kern(K, signs, dd), 10)[0]
        plain_ms = cuda_ms(lambda: plain(K, signs, dd), 2)[0]
        numbers[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                             bound_by=bound_by, library_ms=lib_ms)
        print(f'# phase 12: {name} ({tag}) at B={B}, N={N}: kernel '
              f'{ms:.4f} ms, K6 + K7 {k6_ms + k7_ms:.4f} ms (K6 {k6_ms:.4f}, '
              f'K7 {k7_ms:.4f}), plain {plain_ms:.4f} ms, '
              f'torch.linalg.inv(K) {lib_ms:.4f} ms, bound {bound_ms:.5f} ms '
              f'({bound_by}; {ops / 1e9:.2f} GFLOP FP32, '
              f'{nbytes / 1e6:.1f} MB) [{card}]')
    return numbers


def fused_exact(K, signs, dd, label):
    """fused_bitwise, and K9 and K10 each within LDL_TOL * max(1, |v|_inf)
    per instance of its plain version.  Returns those distances, by
    name."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    from cvxpygen_tpu_torch.solvers.admm import full_f32_matmul
    with full_f32_matmul():
        _, outs = fused_bitwise(K, signs, dd, label)
        errs = {}
        for name, tag, _, pname, _ in FUSED:
            ref = getattr(lk, pname)(K, signs, dd)
            errs[name] = float(inst_err(outs[name], ref).max())
            check(errs[name] <= LDL_TOL,
                  f'{tag} at {label}: {errs[name]:.3e} > {LDL_TOL}')
    return errs


@contextlib.contextmanager
def recorded_calls(module, name):
    """``module.name`` wrapped for the block so that each call keeps its
    arguments (K cloned) in the list yielded."""
    fn, calls = getattr(module, name), []

    def record(K, *args):
        calls.append((K.clone(), *args))
        return fn(K, *args)
    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


def fused_large_n(card, Ns=(801, 1601), B=4):
    """K9 and K10 where the factor and R live in the device scratch, on
    phase 10's well-conditioned K: fused_exact; the fused kernel's time
    beside K6 + K7's."""
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    g = torch.Generator(device='cuda').manual_seed(3)
    for N in Ns:
        K, signs = well_conditioned_large(N, B, g)
        errs = fused_exact(K, signs, 1e-4, f'N={N}, B={B}')
        ms = cuda_ms(lambda: lk.ldl_kinv_kernel(K, signs, 1e-4), 3)[0]
        fac = lk.ldl_factor_kernel(K, signs, 1e-4)
        k67_ms = (cuda_ms(lambda: lk.ldl_factor_kernel(K, signs, 1e-4), 3)[0]
                  + cuda_ms(lambda: lk.ldl_inverse_kernel(fac), 3)[0])
        print(f'# phase 12: K9 and K10 at N={N}, B={B}: max |d| / max(1, '
              f'|v|_inf) to their plain versions '
              + ', '.join(f'{t} {errs[n]:.3e}' for n, t, *_ in FUSED)
              + f'; fused {ms:.4f} ms, K6 + K7 {k67_ms:.4f} ms [{card}]')


def fused_counts():
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    return {k: getattr(lk, k).launches for k in (
        'ldl_factor_kernel', 'ldl_inverse_kernel', 'ldl_solve_kernel',
        'ldl_factor_inverse_kernel', 'ldl_kinv_kernel')}


def reset_fused_counts():
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    for k in fused_counts():
        getattr(lk, k).launches = 0


def phase_fused(card, first, twin, dd, esolver, etheta, est, lse, default,
                asolver, atheta, tst, arefs, two_level_out):
    """Phase 12: K9 and K10 on the entropy KKT matrices (``first``: phase
    10's first-iteration K and signs, N=161, B=1024; ``twin``: the n=64
    twin, N=321, B=64) and at N=801 and 1601, then the 'ldl' IPM through
    each: entropy B=1024 under CPG_LDL_FUSED=1 (K9) and under
    CPG_LDL_BM_FUSED=1 (K10), each with every instance solved within the
    parity bar, per-instance iterations and status equal to the default
    route's (``default``: phase 11's K6 + K7 result and its K6 launches),
    the fused kernel launched as often as K6 there and K6, K7 and K8 never;
    ADP through the two-level route under CPG_LDL_FUSED=1 (K9 on both
    levels), every instance solved within the parity bar, per-instance
    iterations and status equal to the K6 + K7 two-level route's
    (``two_level_out``), and every K that route gave K9 (the saddle block
    Ktop once, the Schur complement S every iteration) held by
    fused_exact.  The variables are set and restored here.  Returns the
    kernels' numbers and the launches of their entropy runs."""
    numbers = compare_fused(*first, dd, card)
    KL, sL = twin
    fused_bitwise(KL, sL, dd, f'the n=64 twin (N={KL.shape[1]}, '
                  f'B={KL.shape[0]})')
    fused_large_n(card)
    default_out, k6_launches = default
    launches = {}
    for name, tag, kname, _, var in FUSED:
        with env_set(var, '1'):
            reset_fused_counts()
            out = esolver.solve_batch(etheta, settings=est)
            counts = fused_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            reps = 2
            for _ in range(reps):
                esolver.solve_batch(etheta, settings=est)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) / reps
        gate_conic(f'entropy n={ENTROPY_N} under {var}=1 ({tag})', out, lse,
                   dt, f'{tag} {counts[kname]}, K6 '
                   f'{counts["ldl_factor_kernel"]}, K7 '
                   f'{counts["ldl_inverse_kernel"]}', card, maximize=True,
                   phase='phase 12')
        n_iters = int((out['iters'] != default_out['iters']).sum())
        n_status = int((out['status'] != default_out['status']).sum())
        print(f'# phase 12: entropy under {var}=1 ({tag}) against the '
              f'default K6 + K7 route: {n_iters} instances at other '
              f'iterations, {n_status} of other status; {tag} launched '
              f'{counts[kname]} times, K6 {k6_launches} on the default route')
        check(n_iters == 0 and n_status == 0,
              f'{var}: iterations or status differ from the default route')
        check(counts[kname] == k6_launches,
              f'{var}: {tag} launched {counts[kname]} times, K6 '
              f'{k6_launches} on the default route')
        check(sum(v for k, v in counts.items() if k != kname) == 0,
              f'{var}: other LDL kernels launched: {counts}')
        launches[name] = counts[kname]
    from cvxpygen_tpu_torch.solvers import ipm
    with env_set('CPG_LDL_FUSED', '1'), recorded_calls(
            ipm, 'ldl_factor_inverse_kernel') as calls:
        reset_fused_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = asolver.solve_batch(atheta, settings=tst)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = fused_counts()
    gate_conic('ADP SOCP through the two-level ldl route under '
               'CPG_LDL_FUSED=1 (one call)', out, arefs, dt,
               f'K9 {counts["ldl_factor_inverse_kernel"]}, others '
               f'{sum(counts.values()) - counts["ldl_factor_inverse_kernel"]}',
               card, phase='phase 12')
    check(counts['ldl_factor_inverse_kernel'] > 1
          and sum(counts.values()) == counts['ldl_factor_inverse_kernel'],
          f'two-level under CPG_LDL_FUSED=1: launches {counts}')
    check(len(calls) == counts['ldl_factor_inverse_kernel'],
          f'two-level: {len(calls)} calls recorded, '
          f'{counts["ldl_factor_inverse_kernel"]} K9 launches')
    for i, (K, signs, dd_i) in enumerate(calls):
        label = (f'the ADP two-level route\'s '
                 f'{"Ktop" if i == 0 else f"S of iteration {i}"} '
                 f'(N={K.shape[1]}, B={K.shape[0]})')
        errs = fused_exact(K, signs, dd_i, label)
        print(f'# phase 12: K9 and K10 at {label}: max |d| / max(1, |v|_inf) '
              'to their plain versions '
              + ', '.join(f'{t} {errs[n]:.3e}' for n, t, *_ in FUSED))
    it, it67 = out['iters'].float(), two_level_out['iters'].float()
    n_iters = int((out['iters'] != two_level_out['iters']).sum())
    n_status = int((out['status'] != two_level_out['status']).sum())
    print(f'# phase 12: ADP two-level under CPG_LDL_FUSED=1: mean iters '
          f'{float(it.mean()):.4f} (max {int(it.max())}), the K6 + K7 '
          f'two-level route {float(it67.mean()):.4f} (max {int(it67.max())}); '
          f'{n_iters} instances at other iterations, {n_status} of other '
          'status')
    check(n_iters == 0 and n_status == 0, 'ADP two-level under '
          'CPG_LDL_FUSED=1: iterations or status differ from K6 + K7')
    check('CPG_LDL_FUSED' not in os.environ
          and 'CPG_LDL_BM_FUSED' not in os.environ,
          'phase 12 left a variable set')
    return numbers, launches


# ---------------------------------------------------------------------------
# phase 13: the fused banded iteration (kernel K11)
# ---------------------------------------------------------------------------

# K11 against its plain version and the K4 route on charging T=1440: x, z
# and y within K11_TOL * max(1, |v|_inf) per instance after one check
# interval of the charging settings (50 iterations) from the state that
# K11_START_ITERS iterations of the K4 route reach from zero.  With a
# refinement sweep, which the K4 route does not make, the distance to the
# route is held to max(K11_TOL, twice the plain version's)
K11_TOL = 1e-4
K11_START_ITERS = 100


def k11_bound(nb_tot, s, nb, n, m, nnz_a, B, n_iters, refine):
    """Least time of K11's work on these inputs: the FP32 operations over
    the FP32 peak against the bytes over the HBM rate.  Operations, on the
    real data: per instance and iteration the A' and A products (nnz(A)
    multiply-adds each) and the CR solve (every packed block applied
    once), and per refinement sweep one more CR solve and the banded M
    matvec (its dense blocks); element-wise updates left out.  Bytes: the
    shared factor, A (and M) once; each instance's q, l, u in and x, z, y
    in and out."""
    m_words = (nb + 2 * (nb - 1)) * s * s
    per_iter = (2 * nnz_a + nb_tot * s * s
                + refine * (nb_tot * s * s + m_words))
    ops = 2.0 * B * n_iters * per_iter
    shared_words = nb_tot * s * s + nnz_a + m + refine * m_words
    nbytes = 4.0 * (shared_words + B * 3 * (n + 2 * m))
    t_ops, t_bytes = ops / FP32_PEAK, nbytes / HBM_RATE
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', ops, nbytes)


def inst_err_last(a, b):
    """inst_err with the batch on the last axis (the banded layouts)."""
    return inst_err(a.movedim(-1, 0), b.movedim(-1, 0))


def first_cols(t, n):
    """A contiguous copy of the first n instances of a (., B) tensor."""
    return t[..., :n].clone(memory_format=torch.contiguous_format)


def k11_partial(k45, shared, q, l, u, start, ikw, B=5):
    """K11 on the first B instances at two per thread block (the last group
    partial), kkt_refine 0 and 1: x, z, y within K11_TOL * max(1,
    |v|_inf) of its plain version and bitwise equal at one per block."""
    fac, meta, B0, B1, D_M, L_M, rho = shared
    sub = [first_cols(t, B) for t in (q, l, u)]
    for refine in (0, 1):
        outs = {}
        for grp in (2, 1):
            xs, zs, ys = (first_cols(t, B) for t in start)
            k45.banded_iterate(fac, meta, B0, B1, D_M, L_M, rho, *sub, xs,
                               zs, ys, kkt_refine=refine, group=grp, **ikw)
            outs[grp] = (xs, zs, ys)
        xp, zp, yp = (first_cols(t, B) for t in start)
        k45.banded_iterate_plain(fac, meta, B0, B1, D_M, L_M, rho, *sub, xp,
                                 zp, yp, kkt_refine=refine, **ikw)
        err = max(float(inst_err_last(a, b).max())
                  for a, b in zip(outs[2], (xp, zp, yp)))
        same = all(torch.equal(a, b) for a, b in zip(outs[2], outs[1]))
        print(f'# phase 13: K11 kkt_refine={refine}, B={B} at 2 instances '
              f'per block (a partial last group): max |d| / max(1, '
              f'|v|_inf) to its plain version {err:.3e}; bitwise equal at 1 '
              f'per block {same}')
        check(err <= K11_TOL and same, f'K11 partial group, kkt_refine='
              f'{refine}: {err:.3e}, bitwise {same}')


def k11_state_bytes(nb, s, r_max, B):
    """Bytes of per-instance state that one K11 iteration moves between
    the SMs and L2 (a model of the design, not a reading): z, y read in
    the A' and the A pass, l, u read and z, y written in the A pass, q read
    in the A' pass."""
    return 4.0 * B * (8 * nb * r_max + nb * s)


def k11_sweeps(k45, shared, q, l, u, start, ikw, card):
    """K11's time (50 iterations, kkt_refine 0) by pinned group at B=256,
    and at two instances per block by batch: 2 (one thread block), 64, 128
    and 256 (128 blocks on 132 SMs): every block runs at once, so the time
    above one block's is what the blocks' shared L2 and device memory
    traffic (the factor, the A windows and each instance's state) costs.
    Beside it the state bytes per iteration by the design's model
    (k11_state_bytes), which is not a reading; ab_kernels.py k11state
    times the state traffic itself."""
    fac, meta, B0, B1, D_M, L_M, rho = shared
    nb, s, B = start[0].shape
    r_max = l.shape[1]

    def timed(Bc, grp):
        sub = [first_cols(t, Bc) for t in (q, l, u)]
        xs, zs, ys = (first_cols(t, Bc) for t in start)
        return cuda_ms(lambda: k45.banded_iterate(
            fac, meta, B0, B1, D_M, L_M, rho, *sub, xs, zs, ys, kkt_refine=0,
            group=grp, **ikw), 3)[0]

    by_group = {grp: timed(B, grp) for grp in (1, 2, 4)}
    by_batch = {Bc: timed(Bc, 2) for Bc in (2, 64, 128, B)}
    n_it = ikw['check_interval']
    print(f'# phase 13: K11 by instances per block at B={B}, {n_it} '
          'iterations: ' + ', '.join(f'{k}: {v:.4f} ms'
                                     for k, v in by_group.items())
          + f' (the rule: {k45.iterate_launch_plan(nb, s, B, 0)[0]}); at 2 '
          'per block by batch: ' + ', '.join(
              f'B={k} {v:.4f} ms' for k, v in by_batch.items())
          + f'; state bytes per iteration at B={B} by the design\'s model '
          f'(k11_state_bytes; not a reading) '
          f'{k11_state_bytes(nb, s, r_max, B) / 1e6:.1f} MB [{card}]')


def phase_iterate(card, dev='cuda'):
    """Phase 13: K11 on charging T=1440 at B=256 (phase 9's batch and
    settings): the shared engine's set-up through the port's own functions,
    a mid-solve state from the K4 route, K11 for one check interval at
    kkt_refine 0 and 1 against its plain version and against the K4 route
    at the same fixed rho; times and the bound; then K4, K11 and the
    float32 set-up held bitwise equal across two calls, and two eps-1e-4
    solves to equal mean iterations.  Returns K11's
    numbers and the launches of its two checked calls."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import banded_shared_kernel as k45
    from cvxpygen_tpu_torch.runtime.solver import CompiledBandedQPSolver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings

    cprob = charging_problem(ct)
    cfam = canonicalize(cprob)
    cst = ADMMSettings(**CHARGING_SETTINGS)
    csolver = CompiledBandedQPSolver(cfam, settings=cst, device=dev)
    st, ga = csolver.struct, csolver.grouped
    ctheta = charging_batch(cfam, cprob, B_CHARGING)
    args = banded_args(csolver, ctheta, cst)
    (fac, meta, B0, B1, D_P, L_P, D_M, L_M, D, Einv, E, rho, c_inv, qx, lg,
     ug, x, z, y) = args
    B = x.shape[-1]
    n_it = cst.check_interval
    done = torch.zeros((1, 1, B), dtype=torch.int32, device=dev)
    ikw = dict(sigma=cst.sigma, alpha=cst.alpha, check_interval=n_it)

    def k4_route(xs, zs, ys):
        """The K4 route of the solve loop (K5's plain version with K4 as
        its CR solve) for one check interval at the base rho, unscaled."""
        k45.banded_shared_chunk_plain(
            fac, meta, B0, B1, D_P, L_P, D_M, L_M, D, Einv, E, rho, c_inv,
            qx, lg, ug, xs, zs, ys, done, eps_abs=cst.eps_abs,
            eps_rel=cst.eps_rel, kkt_refine=0, solve=k45.cr_solve, **ikw)

    for _ in range(K11_START_ITERS // n_it):
        k4_route(x, z, y)
    rho3 = rho[:, :, None]
    ls, us = lg * rho3, ug * rho3

    def scaled():
        return x.clone(), (z * rho3).contiguous(), y.clone()

    x4, z4, y4 = x.clone(), z.clone(), y.clone()
    k4_route(x4, z4, y4)
    max_err = 0.0
    plans = {refine: k45.iterate_launch_plan(st.nb, st.s, B, refine)
             for refine in (0, 1)}
    # the main path: one call at each kkt_refine, counted alone
    k45.banded_iterate.launches = 0
    runs = {}
    for refine in (0, 1):
        runs[refine] = scaled()
        k45.banded_iterate(fac, meta, B0, B1, D_M, L_M, rho, qx, ls, us,
                           *runs[refine], kkt_refine=refine, **ikw)
    torch.cuda.synchronize()
    launches = k45.banded_iterate.launches
    for refine in (0, 1):
        xk, zk, yk = runs[refine]
        g, tile, smem = plans[refine]
        print(f'# phase 13: K11 kkt_refine={refine}: the grouped launch, '
              f'{g} instances per thread block ({-(-B // g)} blocks), CR '
              f'steps of {tile} block pairs, {smem} B of shared memory')
        check(k45._LIB_ITERATE.banded_iterate_smem_bytes(
            st.nb, st.s, g, tile, refine) == smem,
            f'K11 shared-memory rule at kkt_refine={refine}')
        xp, zp, yp = scaled()
        k45.banded_iterate_plain(fac, meta, B0, B1, D_M, L_M, rho, qx, ls,
                                 us, xp, zp, yp, kkt_refine=refine, **ikw)
        route = (x4, z4 * rho3, y4)
        to_plain = [float(inst_err_last(a, b).max())
                    for a, b in zip((xk, zk, yk), (xp, zp, yp))]
        to_k4 = [float(inst_err_last(a, b).max())
                 for a, b in zip((xk, zk, yk), route)]
        # the K4 route has no refinement sweep: with one, the iteration
        # differs from it by the sweep's own float32 effect, which the
        # plain version shows; the kernel is held to twice that there
        plain_k4 = [float(inst_err_last(a, b).max())
                    for a, b in zip((xp, zp, yp), route)]
        route_bar = (K11_TOL if refine == 0
                     else max(K11_TOL, 2 * max(plain_k4)))
        print(f'# phase 13: K11 kkt_refine={refine}, B={B}, {n_it} '
              f'iterations from the state after {K11_START_ITERS}: max |d| '
              f'/ max(1, |v|_inf) per instance, x, z, y: to its plain '
              f'version ' + ', '.join(f'{e:.3e}' for e in to_plain)
              + f' (bar {K11_TOL}); to the K4 route '
              + ', '.join(f'{e:.3e}' for e in to_k4)
              + f' (bar {route_bar:.3e}; the plain version to the K4 route '
              + ', '.join(f'{e:.3e}' for e in plain_k4) + ')')
        check(all(bool(torch.isfinite(v).all()) for v in (xk, zk, yk)),
              f'K11 kkt_refine={refine}: non-finite state')
        check(max(to_plain) <= K11_TOL,
              f'K11 kkt_refine={refine}: {max(to_plain):.3e} > {K11_TOL} '
              'from its plain version')
        check(max(to_k4) <= route_bar,
              f'K11 kkt_refine={refine}: {max(to_k4):.3e} > {route_bar:.3e} '
              'from the K4 route')
        if refine == 0:
            max_err = max(to_plain)
        # every group of instances per thread block that fits gives the
        # same bits (four do not fit beside a refinement sweep's buffers)
        same = {}
        for grp in (1, 2) if refine else (1, 2, 4):
            xg, zg, yg = scaled()
            k45.banded_iterate(fac, meta, B0, B1, D_M, L_M, rho, qx, ls, us,
                               xg, zg, yg, kkt_refine=refine, group=grp,
                               **ikw)
            same[grp] = all(torch.equal(a, b) for a, b in
                            zip((xg, zg, yg), (xk, zk, yk)))
        print(f'# phase 13: K11 kkt_refine={refine}: pinned groups bitwise '
              'equal to the plan\'s: '
              + ', '.join(f'{k} {v}' for k, v in same.items()))
        check(all(same.values()), f'K11 kkt_refine={refine}: a group '
              'changes the bits')
    k11_partial(k45, (fac, meta, B0, B1, D_M, L_M, rho), qx, ls, us,
                scaled(), ikw)

    xs, zs, ys = scaled()
    ms = cuda_ms(lambda: k45.banded_iterate(
        fac, meta, B0, B1, D_M, L_M, rho, qx, ls, us, xs, zs, ys,
        kkt_refine=0, **ikw), 5)[0]
    xs, zs, ys = scaled()
    ms_refine = cuda_ms(lambda: k45.banded_iterate(
        fac, meta, B0, B1, D_M, L_M, rho, qx, ls, us, xs, zs, ys,
        kkt_refine=1, **ikw), 3)[0]
    xs, zs, ys = scaled()
    plain_ms = cuda_ms(lambda: k45.banded_iterate_plain(
        fac, meta, B0, B1, D_M, L_M, rho, qx, ls, us, xs, zs, ys,
        kkt_refine=0, **ikw), 1)[0]
    xs, zs, ys = scaled()
    route_ms = cuda_ms(lambda: k45.banded_iterate_plain(
        fac, meta, B0, B1, D_M, L_M, rho, qx, ls, us, xs, zs, ys,
        kkt_refine=0, solve=k45.cr_solve, **ikw), 3)[0]
    bound_ms, bound_by, ops, nbytes = k11_bound(
        meta['total'], st.s, st.nb, st.n, st.m, len(st.a_row), B, n_it, 0)
    print(f'# phase 13: K11 at nb={st.nb}, s={st.s}, r_max={ga.r_max}, '
          f'B={B}, {n_it} iterations: kernel {ms:.4f} ms (kkt_refine=1: '
          f'{ms_refine:.4f} ms), plain {plain_ms:.4f} ms, the K4 route (K4 '
          f'plus torch glue, no checks, fixed rho) {route_ms:.4f} ms, bound '
          f'{bound_ms:.5f} ms ({bound_by}; {ops / 1e9:.2f} GFLOP FP32, '
          f'{nbytes / 1e6:.1f} MB) [{card}]')
    k11_sweeps(k45, (fac, meta, B0, B1, D_M, L_M, rho), qx, ls, us,
               scaled(), ikw, card)

    # determinism of the K4 route and of its set-up
    g = torch.Generator(device=dev).manual_seed(1)
    b = torch.randn(tuple(x.shape), generator=g, device=dev, dtype=x.dtype)
    same_k4 = torch.equal(k45.cr_solve(fac, meta, b),
                          k45.cr_solve(fac, meta, b))
    runs = [scaled(), scaled()]
    for xs, zs, ys in runs:
        k45.banded_iterate(fac, meta, B0, B1, D_M, L_M, rho, qx, ls, us, xs,
                           zs, ys, kkt_refine=0, **ikw)
    same_k11 = all(torch.equal(a, b) for a, b in zip(*runs))
    args2 = banded_args(csolver, ctheta, cst)
    same_setup = {name: torch.equal(a, b) for name, a, b in (
        ('B0', B0, args2[2]), ('B1', B1, args2[3]), ('D_M', D_M, args2[6]),
        ('L_M', L_M, args2[7]), ('factor', fac, args2[0]))}
    tight = dataclasses.replace(cst, eps_abs=CHARGING_TIGHT_EPS,
                                eps_rel=CHARGING_TIGHT_EPS)
    means = [float(csolver.solve_batch(ctheta, settings=tight)['iters']
                   .float().mean()) for _ in range(2)]
    print(f'# phase 13: determinism: K4 twice on one right-hand side '
          f'bitwise equal {same_k4}; K11 twice {same_k11}; the float32 '
          f'set-up twice, bitwise equal: '
          + ', '.join(f'{k} {v}' for k, v in same_setup.items())
          + f'; charging at eps {CHARGING_TIGHT_EPS:g} twice: mean iters '
          + ' and '.join(f'{v:.2f}' for v in means))
    check(same_k4 and same_k11, 'K4 or K11 is not deterministic')
    check(all(same_setup.values()), 'the float32 banded set-up differs '
          'between two calls: ' + ', '.join(
              k for k, v in same_setup.items() if not v))
    check(means[0] == means[1], f'two eps-{CHARGING_TIGHT_EPS:g} charging '
          f'solves differ in mean iterations: {means}')
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None), launches


# ---------------------------------------------------------------------------
# phase 14: the conic ADMM (the SCS route; torch, no kernel)
# ---------------------------------------------------------------------------

# the entropy row's family and batch (phase 11's), the conic ADMM at these
# settings (the rest at ConicADMMSettings' defaults); its float32 floor is
# about 2e-4 (tests/test_f32.py:105-109)
CONIC_ADMM_SETTINGS = dict(eps_abs=1e-3, eps_rel=1e-3, max_iter=20000)
B_CONIC_ADMM = 1024
# examples/logistic_and_sdp.py: 20 samples, 4 features, lambda 0.1; PSD s=5
LOGISTIC_SAMPLES = 20
LOGISTIC_FEATURES = 4
LOGISTIC_LAMBDA = 0.1
N_ORACLE_LOGISTIC = 32
# the logistic batch also runs at this eps, where adaptive rho no longer
# stops it early (ROADMAP.md A6), against the oracle
LOGISTIC_TIGHT_EPS = 3e-5
# worker processes of the logistic oracle (the card's host has 8 cores; one
# is left to the process that drives the card)
ORACLE_WORKERS = 6
SDP_S = 5


def logistic_problem(ct):
    """examples/logistic_and_sdp.py's logistic regression family."""
    w = ct.Variable(LOGISTIC_FEATURES, name='w')
    Z = ct.Parameter((LOGISTIC_SAMPLES, LOGISTIC_FEATURES), name='Z')
    return ct.Problem(ct.Minimize(
        ct.sum(ct.logistic(Z @ w))
        + LOGISTIC_LAMBDA * ct.sum_squares(w))), Z


def logistic_batch(fam, prob, Z, B):
    """B datasets drawn as in examples/logistic_and_sdp.py (rows of Z are
    -y_i x_i), from default_rng(0)."""
    rng = np.random.default_rng(0)
    thetas = []
    for _ in range(B):
        X = rng.normal(size=(LOGISTIC_SAMPLES, LOGISTIC_FEATURES))
        w_true = rng.normal(size=LOGISTIC_FEATURES)
        y = np.sign(X @ w_true + 0.3 * rng.normal(size=LOGISTIC_SAMPLES))
        Z.value = -y[:, None] * X
        thetas.append(fam.pack_theta(params=prob.parameters()))
    return np.stack(thetas)


def sdp_problem(ct):
    """examples/logistic_and_sdp.py's max-eigenvalue SDP: the smallest t
    with t I >= A."""
    t = ct.Variable(name='t')
    A = ct.Parameter((SDP_S, SDP_S), name='A')
    return ct.Problem(ct.Minimize(t), [ct.multiply(t, np.eye(SDP_S)) >> A]), A


def sdp_batch(fam, prob, A, B):
    rng = np.random.default_rng(0)
    thetas, lam = [], []
    for _ in range(B):
        M = rng.normal(size=(SDP_S, SDP_S))
        M = 0.5 * (M + M.T)
        A.value = M
        thetas.append(fam.pack_theta(params=prob.parameters()))
        lam.append(M)
    lam_max = torch.linalg.eigvalsh(
        torch.as_tensor(np.stack(lam), dtype=torch.float64)).amax(1)
    return np.stack(thetas), lam_max.tolist()


def _oracle_obj(args):
    """One float64 oracle objective (a worker process's task)."""
    from cvxpygen_tpu_torch.solvers.oracle import solve_family_numpy
    fam, theta, tol = args
    res, _ = solve_family_numpy(fam, theta, tol=tol)
    return res.obj + fam.canon_numpy(theta)[2]


def oracle_objs_async(pool, fam, theta, k, tol=1e-7):
    """oracle_objs in worker processes: the NumPy exp-cone oracle takes
    about 10 s per logistic instance, so the phase's card work overlaps
    it."""
    return pool.map(_oracle_obj, [(fam, theta[i], tol) for i in range(k)])


def timed_solve(solver, theta, settings, reps, **kw):
    """One warm-up call, then the mean host time of ``reps`` calls."""
    out = solver.solve_batch(theta, settings=settings, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = solver.solve_batch(theta, settings=settings, **kw)
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps


def phase_conic_admm(card, dev='cuda'):
    """Phase 14: the conic ADMM (SCS route) at full width: entropy, logistic
    regression and the max-eigenvalue SDP at B=1024, entropy through the
    default generate_code route, and one exp projection's time.  The
    logistic oracle's worker processes stop with the phase, failed or
    not."""
    pool = ProcessPoolExecutor(
        ORACLE_WORKERS, mp_context=multiprocessing.get_context('spawn'))
    try:
        conic_admm_checks(card, dev, pool)
    finally:
        pool.shutdown(cancel_futures=True)


def conic_admm_checks(card, dev, pool):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch import cpg
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops.cones import _proj_exp_block
    from cvxpygen_tpu_torch.runtime.solver import (
        CompiledConicADMMSolver, make_compiled_solver, use_shared_path)
    from cvxpygen_tpu_torch.solvers.conic_admm import ConicADMMSettings
    st = ConicADMMSettings(**CONIC_ADMM_SETTINGS)

    # the logistic batch's float64 oracle starts first, in worker processes
    lprob, Z = logistic_problem(ct)
    Z.value = np.zeros((LOGISTIC_SAMPLES, LOGISTIC_FEATURES))
    lfam = canonicalize(lprob)
    ltheta = logistic_batch(lfam, lprob, Z, B_CONIC_ADMM)
    t_pool = time.perf_counter()
    lrefs = oracle_objs_async(pool, lfam, ltheta, N_ORACLE_LOGISTIC)

    # entropy at bench.py's shape (phase 11's batch)
    eprob, ec = entropy_problem(ct, ENTROPY_N)
    cs = np.random.default_rng(5).normal(size=(B_CONIC_ADMM, ENTROPY_N))
    ec.value = cs[0]
    efam = canonicalize(eprob)
    etheta = entropy_batch(efam, eprob, cs)
    lse = list(np.log(np.sum(np.exp(cs), axis=1)))
    esolver = make_compiled_solver(efam, 'SCS', device=dev)
    check(isinstance(esolver, CompiledConicADMMSolver)
          and esolver.jf.maps.dtype == torch.float32
          and use_shared_path(esolver._pa_mask, etheta, 'auto'),
          'entropy: the shared conic ADMM in float32')
    out, dt = timed_solve(esolver, etheta, st, 3)
    gate_conic(f'entropy n={ENTROPY_N} through the conic ADMM (shared)',
               out, lse, dt, 'none (torch)', card, maximize=True,
               phase='phase 14')
    batch_iters = int(out['iters'].max())
    out64 = make_compiled_solver(efam, 'SCS', dtype=torch.float64,
                                 device=dev).solve_batch(etheta, settings=st)
    err64, _ = parity(-(out64['obj'] + out64['d']).cpu().numpy(), lse)
    print(f'# phase 14: entropy: the same settings in float64 on the card: '
          f'max rel {err64:.3e} against logsumexp(c), mean iters '
          f'{float(out64["iters"].float().mean()):.2f}')

    # one exp projection of the entropy batch (the loop's glue)
    cone = 3 * efam.n_exp
    v = torch.as_tensor(np.random.default_rng(7).normal(
        size=(B_CONIC_ADMM, efam.n_exp, 3)), dtype=torch.float32, device=dev)
    _proj_exp_block(v)
    ms, _ = cuda_ms(lambda: _proj_exp_block(v), 10)
    print(f'# phase 14: one exp projection of the entropy batch '
          f'({B_CONIC_ADMM} x {efam.n_exp} cones, {cone} rows, 64 bisection '
          f'trips): {ms:.4f} ms; one per iteration, {batch_iters} iterations '
          f'per batch: {batch_iters * ms:.1f} of its {1e3 * dt:.1f} ms '
          f'[{card}]')

    # the default generate_code route picks SCS; the same solve on the CPU
    # in float64 gives the answer of these settings' stopping rule
    vals = {}
    for where in ('cpu', dev):
        ec.value = cs[0]
        mod = cpg.generate_code(eprob, code_dir=os.path.join(
            ROOT, 'build', 'chip_smoke', f'entropy_scs_{where}'), device=where)
        check(mod._runtime.solver.solver_name == 'CONIC_ADMM'
              and mod._runtime.requested_solver == 'SCS',
              f'entropy default route: {mod._runtime.requested_solver}')
        t0 = time.perf_counter()
        vals[where] = eprob.solve(method='CPG', **CONIC_ADMM_SETTINGS)
        t_first = time.perf_counter() - t0
        it_first = eprob.solver_stats.num_iters
        check(eprob.status == 'optimal', f'entropy SCS CPG {eprob.status}')
    val, val64 = vals[dev], vals['cpu']
    rel = abs(val - val64) / max(1.0, abs(val64))
    reps, iters = 5, []
    t0 = time.perf_counter()
    for _ in range(reps):
        eprob.solve(method='CPG', **CONIC_ADMM_SETTINGS)
        check(eprob.status == 'optimal', f'entropy SCS CPG {eprob.status}')
        iters.append(eprob.solver_stats.num_iters)
    t_steady = (time.perf_counter() - t0) / reps
    print(f'# phase 14: entropy generate_code (default route SCS) -> '
          f'solve(method=CPG): optimal, objective {val:.6f}, the CPU '
          f'float64 run {val64:.6f} (rel {rel:.2e}), logsumexp(c) '
          f'{lse[0]:.6f} (rel {abs(val - lse[0]) / abs(lse[0]):.2e}, float64 '
          f'{abs(val64 - lse[0]) / abs(lse[0]):.2e}: ROADMAP.md A6); '
          f'{1e3 * t_first:.2f} ms first call ({it_first} iters), '
          f'{1e3 * t_steady:.2f} ms mean of the next {reps} with warm start '
          f'(iters {iters}) [{card}]')
    check(rel <= PARITY_BAR, f'entropy SCS CPG against float64 rel {rel:.3e}')

    # the max-eigenvalue SDP: A enters only b, so the shared engine
    sprob, A = sdp_problem(ct)
    A.value = np.eye(SDP_S)
    sfam = canonicalize(sprob)
    stheta, lam = sdp_batch(sfam, sprob, A, B_CONIC_ADMM)
    ssolver = make_compiled_solver(sfam, 'SCS', device=dev)
    out, dt = timed_solve(ssolver, stheta, st, 1)
    gate_conic(f'max-eigenvalue SDP s={SDP_S} (PSD svec '
               f'{sfam.psd_dims}; shared '
               f'{use_shared_path(ssolver._pa_mask, stheta, "auto")}; '
               'against eigvalsh in float64)', out, lam, dt, 'none (torch)',
               card, phase='phase 14')

    # logistic regression: Z per instance, so the per-instance engine.  At
    # eps 1e-3 adaptive rho stops it up to 7e-2 from the optimum in float32
    # and float64 alike (ROADMAP.md A6): that run is held to the float64 run
    # of the same settings, and the run at LOGISTIC_TIGHT_EPS to the oracle
    lsolver = make_compiled_solver(lfam, 'SCS', device=dev)
    check(not use_shared_path(lsolver._pa_mask, ltheta, 'auto'),
          'logistic: the batch should take the per-instance engine')
    out, dt = timed_solve(lsolver, ltheta, st, 1)
    out64 = make_compiled_solver(lfam, 'SCS', dtype=torch.float64,
                                 device=dev).solve_batch(ltheta, settings=st)
    tight = dataclasses.replace(st, eps_abs=LOGISTIC_TIGHT_EPS,
                                eps_rel=LOGISTIC_TIGHT_EPS)
    t0 = time.perf_counter()
    out_t = lsolver.solve_batch(ltheta, settings=tight)
    torch.cuda.synchronize()
    dt_t = time.perf_counter() - t0
    t0 = time.perf_counter()
    lrefs = list(lrefs)
    print(f'# phase 14: float64 oracle on {N_ORACLE_LOGISTIC} logistic '
          f'instances: {time.perf_counter() - t_pool:.1f} s in '
          f'{ORACLE_WORKERS} processes, {time.perf_counter() - t0:.1f} s '
          f'waited for after the batches [{card}]')
    obj = (out['obj'] + out['d']).double().cpu().numpy()
    obj64 = (out64['obj'] + out64['d']).cpu().numpy()
    err_o, _ = parity(obj, lrefs)
    err_o64, _ = parity(obj64, lrefs)
    gate_conic(f'logistic regression (n={lfam.n}, m={lfam.m}, '
               f'{lfam.n_exp} exp cones; per-instance) at eps 1e-3 against '
               f'its float64 run (the oracle: max rel {err_o:.3e}, float64 '
               f'{err_o64:.3e}; ROADMAP.md A6)', out, list(obj64), dt,
               'none (torch)', card, phase='phase 14')
    gate_conic(f'logistic regression at eps {LOGISTIC_TIGHT_EPS:g} (one '
               'call) against the oracle', out_t, lrefs, dt_t,
               'none (torch)', card, phase='phase 14')


# ---------------------------------------------------------------------------
# phase 15: differentiation (TorchLayer with K1 forward; gradient=True)
# ---------------------------------------------------------------------------

B_LAYER = 256
# the layer's output U and dtheta of the K1 forward against the torch
# loop's, each relative to max(1, its inf-norm) per instance: both
# forwards stop at eps 1e-3 (float32 Newton-Schulz inverses of their own),
# and on an H100 they differ by 1.4e-4 in U and 2.8e-4 in dtheta
LAYER_TOL = 1e-3
GRAD_TOL = 1e-2


def tensors_of(prob, batched, dev, dtype=torch.float32):
    """The problem's parameters as tensors: ``batched`` maps a name to its
    (B, ...) values, which require grad; the rest are the values set."""
    params = list(prob.parameters())
    out = []
    for p in params:
        if p.name() in batched:
            out.append(torch.as_tensor(batched[p.name()], dtype=dtype,
                                       device=dev).requires_grad_())
        else:
            out.append(torch.as_tensor(np.asarray(p.value, dtype=float),
                                       dtype=dtype, device=dev))
    return params, out


def x_init_batch_values(B, seed=0):
    return np.random.default_rng(seed).uniform(-2.0, 2.0, (B, 6))


def active_sets(solver, theta, st):
    """The backward's active set of each instance (autodiff/qp_diff.py's
    rule: a multiplier or a slack beyond ACT_EPS, lower and upper), with
    each row's multiplier and slack, from the same forward solve."""
    from cvxpygen_tpu_torch.autodiff.qp_diff import ACT_EPS
    from cvxpygen_tpu_torch.runtime.torch_family import (canon_batch_shared,
                                                        qp_bounds_batch)
    out = solver.solve_batch(theta, settings=st)
    l, u = qp_bounds_batch(solver.jf, canon_batch_shared(solver.jf,
                                                         theta)['b'])
    y, z = out['y'], out['z']
    slack = torch.cat([torch.abs(z - l), torch.abs(z - u)], dim=1)
    act = torch.cat([y < -ACT_EPS, y > ACT_EPS], dim=1) | (slack < ACT_EPS)
    return act, torch.abs(torch.cat([y, y], dim=1)), slack


def layer_run(layer, tensors, w, card, label):
    """Forward and backward of the layer; returns the output u, dtheta and
    both times.  The loss w.u + |u|^2 / 2 makes the upstream gradient (w +
    u) read the forward's values, so dtheta depends on them and not only
    on the active set."""
    tensors = [t.detach().requires_grad_(t.requires_grad) for t in tensors]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (u,) = layer(*tensors)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ((u * w).sum() + 0.5 * (u * u).sum()).backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grad = [t.grad for t in tensors if t.requires_grad][0]
    check(bool(torch.isfinite(grad).all()) and bool(torch.isfinite(u).all()),
          f'{label}: non-finite layer output or gradient')
    return u.detach(), grad, 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def phase_diff(card, dev='cuda'):
    """Phase 15: TorchLayer on MPC H=10 at B=256 (K1 forward) against the
    torch loop's forward, then generate_code(gradient=True) ->
    cpg_gradient against the CPU float64 run.  Returns K1's launches."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch import cpg
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings

    prob = assign_mpc(mpc_problem(ct))
    fam = canonicalize(prob)
    U = [v for v in prob.variables() if v.name() == 'U'][0]
    params, tensors = tensors_of(
        prob, dict(x_init=x_init_batch_values(B_LAYER)), dev)
    st_auto = ADMMSettings(**BENCH_SETTINGS)
    st_never = dataclasses.replace(st_auto, use_pallas='never')
    check(k1.pick_shared_chunk(B_LAYER, fam.m, fam.n) is not None,
          'no rho group at the layer batch')
    w = torch.as_tensor(np.random.default_rng(3).normal(size=U.shape),
                        dtype=torch.float32, device=dev)
    layer = ct.TorchLayer(prob, parameters=params, variables=[U],
                          settings=st_auto, device=dev)
    ref_layer = ct.TorchLayer(prob, parameters=params, variables=[U],
                              settings=st_never, device=dev)
    layer_run(layer, tensors, w, card, 'warm-up')
    k1.admm_shared_solve.launches = 0
    u, grad, fwd_ms, bwd_ms = layer_run(layer, tensors, w, card,
                                        'K1 forward')
    launches = k1.admm_shared_solve.launches
    check(launches > 0, 'the layer forward did not launch K1')
    k1.admm_shared_solve.launches = 0
    ref_u, ref_grad, ref_fwd, ref_bwd = layer_run(
        ref_layer, tensors, w, card, 'torch-loop forward')
    check(k1.admm_shared_solve.launches == 0,
          "use_pallas='never' launched K1")
    # the instances whose active sets agree between the two forwards
    base = fam.pack_theta(params=prob.parameters())
    xi = [pi for pi in fam.param_info if pi.name == 'x_init'][0]
    theta = np.tile(base, (B_LAYER, 1))
    theta[:, xi.offset:xi.offset + xi.flat_size] = \
        x_init_batch_values(B_LAYER)
    solver = CompiledQPSolver(fam, settings=st_auto, device=dev)
    act_a, y_a, slack_a = active_sets(solver, theta, st_auto)
    act_n, y_n, slack_n = active_sets(solver, theta, st_never)
    differ = act_a != act_n
    n_diff = int(differ.any(dim=1).sum())
    y_diff = float(torch.where(differ, torch.maximum(y_a, y_n), 0.0).max())
    slack_diff = float(torch.where(differ, torch.minimum(slack_a, slack_n),
                                   0.0).max())
    u_scale = torch.clamp(ref_u.abs().flatten(1).amax(dim=1), min=1.0)
    u_err = float(((u - ref_u).abs().flatten(1).amax(dim=1)
                   / u_scale).max())
    scale = torch.clamp(ref_grad.abs().amax(dim=1), min=1.0)
    err = (grad - ref_grad).abs().amax(dim=1) / scale
    max_err = float(err.max())
    print(f'# phase 15: TorchLayer MPC H=10 (n={fam.n}, m={fam.m}), '
          f'B={B_LAYER}: forward {fwd_ms:.3f} ms (K1 launches {launches}), '
          f'backward {bwd_ms:.3f} ms; torch-loop forward {ref_fwd:.3f} ms, '
          f'backward {ref_bwd:.3f} ms [{card}]')
    print(f'# phase 15: active sets differ on {n_diff} of {B_LAYER} '
          f'instances (on rows with |y| <= {y_diff:.2e} and a slack within '
          f'{slack_diff:.2e} of the bound in the two forwards: ROADMAP.md '
          f'A7); over every instance: U max rel {u_err:.3e}, dtheta max '
          f'rel {max_err:.3e}')
    # the float32 forwards put a row's multiplier or slack on either side
    # of ACT_EPS by roundoff (A7), so U and dtheta are held on every
    # instance
    check(u_err <= LAYER_TOL, f'layer output U rel {u_err:.3e}')
    check(max_err <= LAYER_TOL, f'layer dtheta rel {max_err:.3e}')

    # generate_code(gradient=True) -> cpg_gradient on the card and on the
    # CPU in float64 (tests/test_codegen.py::test_gradient_package)
    grads = {}
    for where, eps in ((dev, 1e-5), ('cpu', 1e-9)):
        m_, n_ = 6, 4
        x = ct.Variable(n_, name='x', nonneg=True)
        A = ct.Parameter((m_, n_), name='A')
        b = ct.Parameter(m_, name='b')
        gprob = ct.Problem(ct.Minimize(ct.sum_squares(A @ x - b)))
        np.random.seed(0)
        A.value = np.random.randn(m_, n_)
        b.value = np.random.randn(m_)
        mod = cpg.generate_code(
            gprob, code_dir=os.path.join(ROOT, 'build', 'chip_smoke',
                                         f'grad_code_{where}'),
            solver='OSQP', gradient=True, device=where)
        gprob.solve(method='CPG', eps_abs=eps, eps_rel=eps, max_iter=20000)
        x.gradient = 0.1 * np.ones(n_)
        grads[where] = mod.cpg_gradient(gprob)
    g_dev = np.concatenate([np.ravel(grads[dev][k]) for k in ('A', 'b')])
    g_cpu = np.concatenate([np.ravel(grads['cpu'][k]) for k in ('A', 'b')])
    rel = float(np.max(np.abs(g_dev - g_cpu))
                / max(1.0, np.max(np.abs(g_cpu))))
    print(f'# phase 15: generate_code(gradient=True) -> cpg_gradient on the '
          f'card against the CPU float64 run: max rel {rel:.3e}')
    check(bool(np.all(np.isfinite(g_dev))), 'non-finite cpg_gradient')
    check(rel <= GRAD_TOL, f'cpg_gradient rel {rel:.3e}')
    return launches


# ---------------------------------------------------------------------------
# phase 16: conic and banded differentiation (TorchLayer's conic and banded
# routes, gradient=True on an exp family)
# ---------------------------------------------------------------------------

# dtheta against the port's CPU float64 run of the same instances, relative
# to max(1, |dtheta|_inf) per instance: the float32 forwards stop at 3e-5
# (ADP) and 1e-5 (the runtime's exp gradient settings)
CONIC_DIFF_TOL = 1e-2
N_CONIC_DIFF_REF = 8
B_SDP_DIFF = 256
# the SDP's dA against v v' (the top eigenvector): held where the top
# eigenvalue is apart from the next by SDP_GAP, since dA moves as 1 / gap
SDP_GAP = 0.1
# the tests' charging family (tests/test_qp_diff_banded.py, n + m = 2021 at
# T=288) and the bench's at T=1440 (n + m = 14405), both at eps 1e-4 (A3)
CHARGING_DIFF_T = 288
B_CHARGING_DIFF = 16
B_CHARGING_DIFF_LONG = 8
CHARGING_DIFF_SETTINGS = dict(CHARGING_SETTINGS, eps_abs=CHARGING_TIGHT_EPS,
                              eps_rel=CHARGING_TIGHT_EPS, max_iter=20000)
# the banded backward against the dense one on the same x, y, z
BANDED_DIFF_TOL = 1e-3


def theta_slice(fam, theta, name):
    pi = [x for x in fam.param_info if x.name == name][0]
    return theta[:, pi.offset:pi.offset + pi.flat_size]


def charging_diff_problem(ct, T):
    """tests/test_admm_banded.py:23-40's charging family: prices p, gamma."""
    u = ct.Variable(T, name='u')
    q = ct.Variable(T + 1, name='q')
    p = ct.Parameter(T, nonneg=True, name='p')
    gamma = ct.Parameter(nonneg=True, name='gamma')
    gamma.value = 50.0
    p.value = np.ones(T)
    return ct.Problem(ct.Minimize(p @ u + gamma * ct.sum_squares(u)),
                      [q[1:] == q[:-1] + u,
                       ct.Constant(-0.1) <= u, u <= ct.Constant(0.05),
                       ct.Constant(0) <= q, q <= ct.Constant(1.0),
                       q[0] == 0, q[T] == ct.Constant(1.0)])


def phase_conic_diff(card, dev='cuda'):
    """Phase 16.  Returns the launches of K1 (the QP layer), K6 and K7 (the
    conic layer's 'ldl' forward)."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    from cvxpygen_tpu_torch.runtime.solver import make_compiled_solver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    from cvxpygen_tpu_torch.solvers.ipm import IPMSettings
    launches = {}

    # the QP layer's route: K1 in the forward (phase 15's MPC batch)
    mprob = assign_mpc(mpc_problem(ct))
    U = mprob.var_dict['U']
    params, tensors = tensors_of(
        mprob, dict(x_init=x_init_batch_values(B_LAYER)), dev)
    layer = ct.TorchLayer(mprob, parameters=params, variables=[U],
                          settings=ADMMSettings(**BENCH_SETTINGS),
                          device=dev)
    check(not layer._conic and not layer._banded, 'MPC layer route')
    w = torch.ones(U.shape, dtype=torch.float32, device=dev)
    k1.admm_shared_solve.launches = 0
    layer_run(layer, tensors, w, card, 'MPC QP layer')
    launches['admm_shared_solve'] = k1.admm_shared_solve.launches
    check(launches['admm_shared_solve'] > 0, 'the QP layer did not launch K1')

    # ADP SOCP (bench.py:347-392), B=1024: the default forward ('schur')
    # and the two-level 'ldl' one (K6 + K7), against the CPU float64 run
    aprob = assign_adp(adp_problem(ct))
    afam = canonicalize(aprob)
    atheta = adp_batch(afam, aprob, B_ADP)
    au = aprob.var_dict['u']
    f_batch = theta_slice(afam, atheta, 'f')
    w = torch.as_tensor(np.random.default_rng(4).normal(size=au.shape),
                        dtype=torch.float32, device=dev)
    st = IPMSettings.for_dtype(torch.float32, **ADP_SETTINGS)
    n_ref = N_CONIC_DIFF_REF
    asolver = make_compiled_solver(afam, 'IPM', device=dev)
    ref_layer = ct.TorchLayer(
        aprob, parameters=list(aprob.parameters()), variables=[au],
        settings=IPMSettings.for_dtype(torch.float64,
                                       max_iter=ADP_SETTINGS['max_iter']),
        device='cpu')
    _, ref_t = tensors_of(aprob, dict(f=f_batch[:n_ref]), 'cpu',
                          torch.float64)
    (ref_u,) = ref_layer(*ref_t)
    w64 = w.double().cpu()
    ((ref_u * w64).sum() + 0.5 * (ref_u * ref_u).sum()).backward()
    ref_grad = ref_t[[p.name() for p in aprob.parameters()].index('f')].grad
    for label, s in (("'schur' (the default)", st),
                     ("'ldl', ldl_two_level=True",
                      dataclasses.replace(st, kkt_solver='ldl',
                                          ldl_two_level=True))):
        layer = ct.TorchLayer(aprob, parameters=list(aprob.parameters()),
                              variables=[au], settings=s, device=dev)
        check(layer._conic and not layer._banded, 'ADP layer route')
        _, tensors = tensors_of(aprob, dict(f=f_batch), dev)
        for kern in (lk.ldl_factor_kernel, lk.ldl_inverse_kernel,
                     lk.ldl_solve_kernel):
            kern.launches = 0
        u, grad, fwd_ms, bwd_ms = layer_run(layer, tensors, w, card,
                                            f'ADP {label}')
        counts = (lk.ldl_factor_kernel.launches,
                  lk.ldl_inverse_kernel.launches,
                  lk.ldl_solve_kernel.launches)
        u_err = float(inst_err(u[:n_ref].cpu(), ref_u.detach()).max())
        g_err = float(inst_err(grad[:n_ref].cpu(), ref_grad).max())
        iters = asolver.solve_batch(atheta, settings=s)['iters'].float()
        print(f'# phase 16: TorchLayer ADP SOCP (n={afam.n}, m={afam.m}), '
              f'B={B_ADP}, forward {label}: forward {fwd_ms:.3f} ms, one '
              f'call (the same solve: mean iters {float(iters.mean()):.2f}, '
              f'max {int(iters.max())}; launches K6 {counts[0]}, K7 '
              f'{counts[1]}, K8 {counts[2]}), '
              f'backward {bwd_ms:.3f} ms (LU of the (B, {afam.n + afam.m}, '
              f'{afam.n + afam.m}) sensitivity matrix); against the CPU '
              f'float64 run on {n_ref}: u max rel {u_err:.3e}, df max rel '
              f'{g_err:.3e} [{card}]')
        check(g_err <= CONIC_DIFF_TOL and u_err <= CONIC_DIFF_TOL,
              f'ADP {label}: u {u_err:.3e}, df {g_err:.3e}')
        if s.kkt_solver == 'ldl':
            check(counts[0] > 0 and counts[1] == counts[0]
                  and counts[2] == 0, f'ADP ldl launches {counts}')
            launches['ldl_factor'], launches['ldl_inverse'] = counts[:2]
        else:
            check(counts == (0, 0, 0), f"ADP 'schur' launches {counts}")

    # the max-eigenvalue SDP (examples/logistic_and_sdp.py, s=5), B=256,
    # through the conic ADMM forward at the runtime's float32 gradient
    # settings: dA against v v' at the top eigenvector
    from cvxpygen_tpu_torch.solvers.conic_admm import ConicADMMSettings
    sprob, A = sdp_problem(ct)
    A.value = np.eye(SDP_S)
    sfam = canonicalize(sprob)
    stheta, _ = sdp_batch(sfam, sprob, A, B_SDP_DIFF)
    As = np.stack([sfam.unpack_theta_grad(th)['A'] for th in stheta])
    sst = ConicADMMSettings(eps_abs=1e-5, eps_rel=1e-5, max_iter=20000)
    layer = ct.TorchLayer(sprob, parameters=[A],
                          variables=[sprob.var_dict['t']], settings=sst,
                          device=dev)
    check(layer._conic, 'SDP layer route')
    At = torch.as_tensor(As, dtype=torch.float32, device=dev)
    At.requires_grad_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (tv,) = layer(At)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    tv.sum().backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    # the same per-instance solve as the layer's forward, for its iterations
    iters = make_compiled_solver(sfam, 'SCS', device=dev).solve_batch(
        stheta, settings=sst, shared_PA=False)['iters'].float()
    lam, Q = np.linalg.eigh(As)
    v = Q[:, :, -1]
    err = np.abs(At.grad.double().cpu().numpy()
                 - v[:, :, None] * v[:, None, :]).max(axis=(1, 2))
    gap = lam[:, -1] - lam[:, -2]
    held = gap >= SDP_GAP
    t_err = float(np.abs(tv.detach().double().cpu().numpy()
                         - lam[:, -1]).max())
    print(f'# phase 16: TorchLayer max-eigenvalue SDP s={SDP_S}, '
          f'B={B_SDP_DIFF} (conic ADMM forward, eps 1e-5): forward '
          f'{1e3 * (t1 - t0):.3f} ms (mean iters {float(iters.mean()):.2f}, '
          f'max {int(iters.max())}), backward {1e3 * (t2 - t1):.3f} ms; '
          f't against lambda_max max abs {t_err:.3e}; dA against v v\' max '
          f'abs {float(err[held].max()):.3e} on the {int(held.sum())} '
          f'instances with an eigengap >= {SDP_GAP}, '
          f'{float(err.max()):.3e} on all (smallest gap '
          f'{float(gap.min()):.3e}) [{card}]')
    check(bool(np.all(np.isfinite(err))), 'SDP: non-finite dA')
    check(float(err[held].max()) <= CONIC_DIFF_TOL,
          f'SDP dA {float(err[held].max()):.3e}')

    # generate_code(solver='SCS', gradient=True) on the exp family of
    # tests/test_conic_diff_exotic.py:135-170, B=1, against the CPU float64
    exp_gradient(card, dev)

    # charging T=288 through the layer's banded route (B=16), and the banded
    # backward against the dense one on the same solve
    banded_diff(card, dev)
    return launches


def exp_gradient(card, dev):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch import cpg
    grads, times = {}, {}
    for where in ('cpu', dev):
        x = ct.Variable(2, name='x')
        p = ct.Parameter(2, name='p')
        p.value = np.array([0.5, -0.3])
        prob = ct.Problem(ct.Minimize(ct.sum(ct.exp(x - p))
                                      + ct.sum_squares(x)))
        mod = cpg.generate_code(
            prob, code_dir=os.path.join(ROOT, 'build', 'chip_smoke',
                                        f'exp_grad_{where}'),
            solver='SCS', gradient=True, device=where)
        check(mod._runtime.solver.solver_name == 'CONIC_ADMM',
              'exp gradient package engine')
        prob.solve(method='CPG')
        check(prob.status == 'optimal', f'exp CPG {prob.status}')
        x.gradient = np.array([1.0, 0.0])
        t0 = time.perf_counter()
        grads[where] = mod.cpg_gradient(prob)['p']
        t1 = time.perf_counter()
        mod.cpg_gradient(prob)
        times[where] = (1e3 * (t1 - t0), 1e3 * (time.perf_counter() - t1))
    g, g64 = grads[dev], grads['cpu']
    rel = float(np.abs(g - g64).max() / max(1.0, np.abs(g64).max()))
    print(f'# phase 16: generate_code(solver=SCS, gradient=True) on the exp '
          f'family, cpg_gradient: {g} against the CPU float64 run {g64} '
          f'(max rel {rel:.3e}); {times[dev][0]:.1f} ms first call, '
          f'{times[dev][1]:.1f} ms the next (a float32 conic ADMM re-solve '
          f'at eps 1e-5, then the backward) [{card}]')
    check(bool(np.all(np.isfinite(g))) and rel <= CONIC_DIFF_TOL,
          f'exp cpg_gradient rel {rel:.3e}')


def banded_diff(card, dev):
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.autodiff.qp_diff import qp_vjp
    from cvxpygen_tpu_torch.autodiff.qp_diff_banded import banded_vjp
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.runtime.torch_family import (
        TorchFamily, canon_batch, canon_batch_sparse, qp_bounds_batch)
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    from cvxpygen_tpu_torch.solvers.admm_banded import (
        admm_solve_banded, banded_index, build_banded_structure)
    st = ADMMSettings(**CHARGING_DIFF_SETTINGS)
    T = CHARGING_DIFF_T
    prob = charging_diff_problem(ct, T)
    fam = canonicalize(prob)
    check(fam.n + fam.m > 1500, f'charging T={T}: n + m = {fam.n + fam.m}')
    B = B_CHARGING_DIFF
    rng = np.random.default_rng(0)
    p_batch = 1.0 + 4.0 * rng.random((B, T))
    layer = ct.TorchLayer(prob, parameters=[prob.param_dict['p'],
                                            prob.param_dict['gamma']],
                          variables=[prob.var_dict['u']], settings=st,
                          device=dev)
    check(layer._banded and not layer._conic,
          f'charging T={T}: the banded route')
    _, tensors = tensors_of(prob, dict(p=p_batch), dev)
    w = torch.as_tensor(rng.normal(size=T), dtype=torch.float32, device=dev)
    u, grad, fwd_ms, bwd_ms = layer_run(layer, tensors, w, card,
                                        f'charging T={T}')
    # the same forward, then both backwards on its x, y, z: the banded one
    # in the working dtype and the dense qp_vjp in float64 on the card
    tf = TorchFamily.from_family(fam, device=dev, force_scatter=True)
    struct = build_banded_structure(fam.P_idx, fam.A_idx, fam.n, fam.m)
    ix = banded_index(struct, dev)
    theta = np.tile(fam.pack_theta(params=prob.parameters()), (B, 1))
    theta_slice(fam, theta, 'p')[:] = p_batch
    th = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    data = canon_batch_sparse(tf, th)
    l, u_b = qp_bounds_batch(tf, data['b'])
    res = admm_solve_banded(struct, data['pvals'], data['q'], data['avals'],
                            l, u_b, fam.n_zero, st, index=ix)
    check(bool((res['status'] == 1).all()), 'charging T=288 unsolved')
    iters = res['iters'].float()
    gx = torch.as_tensor(rng.normal(size=(B, fam.n)), dtype=torch.float32,
                         device=dev)
    zero = torch.zeros((B, fam.m), dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_band = banded_vjp(tf, struct, ix, th, res['x'], res['y'], res['z'],
                        data['pvals'], data['avals'], data['q'], l, u_b, gx,
                        zero, zero[:, 0])
    torch.cuda.synchronize()
    t_band = 1e3 * (time.perf_counter() - t0)
    tf64 = TorchFamily.from_family(fam, dtype=torch.float64, device=dev)
    th64 = th.double()
    dense = canon_batch(tf64, th64)
    l64, u64 = qp_bounds_batch(tf64, dense['b'])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d_dense = qp_vjp(tf64, th64, res['x'].double(), res['y'].double(),
                     res['z'].double(), dense['P'], dense['q'], dense['A'],
                     l64, u64, gx.double(), zero.double(),
                     zero[:, 0].double())
    torch.cuda.synchronize()
    t_dense = 1e3 * (time.perf_counter() - t0)
    err = float(inst_err(d_band, d_dense).max())
    print(f'# phase 16: TorchLayer charging T={T} (n={fam.n}, m={fam.m}, '
          f'the banded route), B={B}, eps {CHARGING_TIGHT_EPS:g}: forward '
          f'{fwd_ms:.1f} ms (mean iters {float(iters.mean()):.1f}, max '
          f'{int(iters.max())}), backward {bwd_ms:.3f} ms; the banded '
          f'backward {t_band:.3f} ms against the dense float64 qp_vjp '
          f'{t_dense:.3f} ms on the same x, y, z: max rel {err:.3e} [{card}]')
    check(bool(torch.isfinite(d_band).all()), 'non-finite banded dtheta')
    check(err <= BANDED_DIFF_TOL, f'banded backward rel {err:.3e}')

    # charging T=1440 (the bench's family), B=8: the backward where the
    # dense reduced KKT would take (n + m)^2 x 4 bytes per instance
    cprob = charging_problem(ct)
    cfam = canonicalize(cprob)
    N = cfam.n + cfam.m
    B = B_CHARGING_DIFF_LONG
    ctheta = charging_batch(cfam, cprob, B)
    layer = ct.TorchLayer(cprob, parameters=list(cprob.parameters()),
                          variables=[cprob.var_dict['u']], settings=st,
                          device=dev)
    check(layer._banded, f'charging T={CHARGING_T}: the banded route')
    _, tensors = tensors_of(cprob, dict(p=theta_slice(cfam, ctheta, 'p')),
                            dev)
    w = torch.as_tensor(rng.normal(size=CHARGING_T), dtype=torch.float32,
                        device=dev)
    torch.cuda.reset_peak_memory_stats()
    u, grad, fwd_ms, bwd_ms = layer_run(layer, tensors, w, card,
                                        f'charging T={CHARGING_T}')
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    print(f'# phase 16: TorchLayer charging T={CHARGING_T} (n={cfam.n}, '
          f'm={cfam.m}), B={B}, eps {CHARGING_TIGHT_EPS:g}: forward '
          f'{fwd_ms:.1f} ms, backward {bwd_ms:.3f} ms, peak device memory '
          f'{peak:.1f} MiB (a dense reduced KKT: {4 * N * N / 2 ** 20:.1f} '
          f'MiB per instance in float32) [{card}]')


# ---------------------------------------------------------------------------
# phase 17: the explicit solver
# ---------------------------------------------------------------------------

B_EXPLICIT = 16384
N_ORACLE_EXPLICIT = 64
# the reference's bar against the oracle (tests/test_explicit.py), and the
# card's float32 evaluation against the CPU's (the same table)
EXPLICIT_ORACLE_TOL = 1e-4
EXPLICIT_CPU_TOL = 1e-5


def explicit_regression(ct, q=10, d=5, seed=1):
    """tests/test_explicit.py:12-19."""
    np.random.seed(seed)
    A = np.random.randn(q, d)
    x = ct.Variable(d, name='x')
    b = ct.Parameter(q, name='b')
    prob = ct.Problem(ct.Minimize(ct.sum_squares(A @ x - b)),
                      [ct.diff(x) >= 0, ct.Constant(-np.ones(q)) <= b,
                       b <= 1])
    b.value = -1 + 2 * np.random.default_rng(2).random(q)
    return prob


def explicit_power(ct):
    """tests/test_explicit.py:39-75, the power-scheduling QP."""
    C, D, h, Q = 1, 1, 0.05, 1
    qtar, alpha, beta = 0.5, 0.1, 0.1
    g = ct.Variable(name='g')
    s = ct.Variable(name='s')
    b = ct.Variable(name='b')
    qplus = ct.Variable(name='qplus')
    L = ct.Parameter(name='L')
    S = ct.Parameter(name='S')
    P = ct.Parameter(name='P')
    q = ct.Parameter(name='q')
    obj = P * g * h + alpha * (qplus - qtar) ** 2 + beta * b ** 2
    constr = [L == s + b + g,
              ct.Constant(0) <= s, s <= S, ct.Constant(-C) <= b, b <= D,
              g >= 0, qplus == q - h * b, ct.Constant(0) <= qplus,
              qplus <= Q, ct.Constant(0) <= L, L <= 1,
              ct.Constant(0) <= S, S <= 0.5, ct.Constant(1) <= P, P <= 2,
              ct.Constant(0) <= q, q <= Q]
    rng = np.random.default_rng(2)
    L.value, S.value = rng.random(), 0.5 * rng.random()
    P.value, q.value = 1 + rng.random(), Q * rng.random()
    return ct.Problem(ct.Minimize(obj), constr)


def phase_explicit(card, dev='cuda'):
    """Phase 17: the explicit solver on the regression and power families."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch import cpg
    from cvxpygen_tpu_torch.solvers import explicit
    from cvxpygen_tpu_torch.solvers.oracle import solve_family_numpy
    for name, prob in (('regression', explicit_regression(ct)),
                       ('power', explicit_power(ct))):
        t0 = time.perf_counter()
        mod = cpg.generate_code(
            prob, code_dir=os.path.join(ROOT, 'build', 'chip_smoke',
                                        f'explicit_{name}'),
            solver='explicit', device=dev)
        t_gen = time.perf_counter() - t0
        rt = mod._runtime
        data, fam = rt.data, rt.family
        check(rt.device.type == 'cuda', f'{name}: explicit runtime device')
        obj_oracle = prob.solve()
        x_oracle = np.concatenate([np.ravel(v.value, order='F')
                                   for v in prob.variables()])
        t0 = time.perf_counter()
        prob.solve(method='CPG')
        t_first = time.perf_counter() - t0
        x_cpg = np.concatenate([np.ravel(v.value, order='F')
                                for v in prob.variables()])
        t0 = time.perf_counter()
        for _ in range(5):
            obj = prob.solve(method='CPG')
        t_steady = (time.perf_counter() - t0) / 5
        x_err = float(np.abs(x_cpg - x_oracle).max())
        check(x_err <= EXPLICIT_ORACLE_TOL and abs(obj - obj_oracle)
              <= EXPLICIT_ORACLE_TOL * max(1.0, abs(obj_oracle)),
              f'{name}: CPG x {x_err:.3e} from the oracle')

        # a batch spread over the domain box: the card against the oracle
        # and against the CPU's evaluation of the same table
        rng = np.random.default_rng(6)
        lo, hi = data.th_lb, data.th_ub
        theta = np.tile(fam.pack_theta(params=prob.parameters()),
                        (B_EXPLICIT, 1))
        theta[:, data.th_sel] = lo + (hi - lo) * rng.random(
            (B_EXPLICIT, len(lo)))
        th_dev = torch.as_tensor(theta, device=dev)
        x, _, region = explicit.explicit_evaluate(data, th_dev)
        torch.cuda.synchronize()
        ms, _ = cuda_ms(lambda: explicit.explicit_evaluate(data, th_dev), 20)
        x_cpu, _, reg_cpu = explicit.explicit_evaluate(data, theta,
                                                       device='cpu')
        cpu_err = float((x.cpu() - x_cpu).abs().max())
        same_region = float((region.cpu() == reg_cpu).double().mean())
        errs = []
        for i in range(N_ORACLE_EXPLICIT):
            res, _ = solve_family_numpy(fam, theta[i])
            errs.append(np.abs(x[i].double().cpu().numpy()
                               - res.x[data.store_idx]).max())
        o_err = float(max(errs))
        # the chunked evaluation (its rule for batches whose slack tensor
        # would not fit) on a few chunks of this batch
        old = explicit._SLACK_FLOATS
        explicit._SLACK_FLOATS = (B_EXPLICIT // 5 * data.TEST.shape[0]
                                  * data.TEST.shape[1])
        try:
            x_ch, _, _ = explicit.explicit_evaluate(data, th_dev)
        finally:
            explicit._SLACK_FLOATS = old
        ch_err = float((x_ch - x).abs().max())
        R, t_max, p1 = data.TEST.shape
        print(f'# phase 17: explicit {name} (n={fam.n}, {R} regions, '
              f'{t_max} tests each, p_r={p1 - 1}): generate_code '
              f'{t_gen:.2f} s (the enumeration on the host), '
              f'solve(method=CPG) {1e3 * t_first:.3f} ms first call, '
              f'{1e3 * t_steady:.3f} ms mean of the next five, x max abs '
              f'{x_err:.3e} from the oracle; explicit_evaluate at '
              f'B={B_EXPLICIT}: {ms:.4f} ms ({B_EXPLICIT / ms * 1e3:.4e} '
              f'evaluations/s, CUDA events), x against the oracle on '
              f'{N_ORACLE_EXPLICIT}: max abs {o_err:.3e}, against the CPU '
              f'evaluator on all: {cpu_err:.3e} (same region on '
              f'{same_region:.6f} of them), chunked against whole: '
              f'{ch_err:.3e} [{card}]')
        check(bool(torch.isfinite(x).all()), f'{name}: non-finite x')
        check(o_err <= EXPLICIT_ORACLE_TOL, f'{name}: oracle {o_err:.3e}')
        check(cpu_err <= EXPLICIT_CPU_TOL, f'{name}: CPU {cpu_err:.3e}')
        check(ch_err <= EXPLICIT_CPU_TOL, f'{name}: chunks {ch_err:.3e}')


def adp_problem(ct, n=6, m=3):
    """The ADP family of tests/problems.py:190-204 (reference
    tests/test_E2E_SOCP.py:14-35) in the port's modeling layer."""
    u = ct.Variable((2, m), name='u')
    Rsqrt = ct.Parameter((m, m), name='Rsqrt', diag=True)
    f = ct.Parameter(n, name='f')
    G = ct.Parameter((n, m), name='G')
    objective = ct.Minimize(ct.sum_squares(f + G @ u[0])
                            + ct.sum_squares(Rsqrt @ u[0]))
    return ct.Problem(objective, [ct.norm(u, 2, axis=1) <= 0.1])


def assign_adp(prob, seed=0):
    """tests/problems.py:207-224."""
    np.random.seed(seed)
    state = -2 * np.ones(6) + 4 * np.random.rand(6)
    A_cont = np.array([[0, 0, 0, 1, 0, 0],
                       [0, 0, 0, 0, 1, 0],
                       [0, 0, 0, 0, 0, 1],
                       [0, 0, 0, -state[3], 0, 0],
                       [0, 0, 0, 0, -state[4], 0],
                       [0, 0, 0, 0, 0, -state[5]]])
    B_cont = np.concatenate((np.zeros((3, 3)), np.diag(state[3:])), axis=0)
    td = 0.1
    A, B = np.eye(6) + td * A_cont, td * B_cont
    prob.param_dict['Rsqrt'].value = np.sqrt(0.1) * np.eye(3)
    prob.param_dict['f'].value = A @ state
    prob.param_dict['G'].value = B
    return prob


def adp_batch(fam, prob, B):
    """bench.py:355-361: f scaled by U(0.5, 1.5) per entry."""
    base = fam.pack_theta(params=prob.parameters())
    fi = [pi for pi in fam.param_info if pi.name == 'f'][0]
    theta = np.tile(base, (B, 1))
    theta[:, fi.offset:fi.offset + fi.flat_size] *= np.random.default_rng(
        1).uniform(0.5, 1.5, (B, fi.flat_size))
    return theta


# phases 18-20: the per-stage profile, the parallel layer, the AOT artifact
PARALLEL_RANKS = 2
PARALLEL_TIMEOUT_S = 300
# instances per rank: the MPC batches and the consensus one hold one rho
# group of K1 on each rank (1024: the rule's group at B=2048 and above);
# the small consensus batch (8 a rank) has a group of the whole batch, which
# no rank holds
RANK_B = 1024
RANK_B_SMALL = 8
# the K3 route's small sharded batch: 12 instances a rank, which alone have
# no block of the reference's rule while the whole batch (24 on two ranks)
# has one, so each rank must take K3 from the whole batch's size
RANK_B_ROUTE = 12
CONSENSUS_K = 2
CONSENSUS_SETTINGS = dict(rho_c=2.0, outer_iters=100, eps_consensus=1e-4)
# consensus: the sharded zbar against the single-process one, at equal
# outer iterations; the mean over the ranks sums in another order than
# torch.sum over the whole batch, and float32 roundoff then moves each outer
# iterate slightly (an H100 read 8.382e-09: PERF.md, Findings)
CONSENSUS_TOL = 1e-6
B_MODEL = 64
# the K2 route's sharded batch: 128 instances a rank, 16 of K2's blocks of 8
B_FULL = 256
B_AOT = 256
# x of a sharded, model-axis or exported solve against the single-process
# live one, relative to max(1, |x|_inf) per instance, at equal iterations
# (the model axis, whose row-block products sum in another order, read
# 2.440e-06 on an H100: PERF.md, Findings)
SHARD_TOL = 1e-5


def k3_route_settings():
    """Phase 6's K3 route: the general row's settings (bench.py:312-314)
    with use_pallas='auto' and 12 warm Newton-Schulz sweeps."""
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    return ADMMSettings(**dict(GENERAL_SETTINGS, use_pallas='auto',
                               ns_adapt_iters=12))


def phase_profile(card):
    """Phase 18: runtime/profiling.py's stage split of the per-instance MPC
    solve (the K3 route) at the general row's B."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.runtime.profiling import profile_qp_solve, trace
    from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver
    from cvxpygen_tpu_torch.runtime.torch_family import TorchFamily
    prob = assign_mpc(mpc_problem(ct))
    fam = canonicalize(prob)
    tf = TorchFamily.from_family(fam)
    theta = x_init_batch(fam, prob, B_MAIN)
    st = k3_route_settings()
    prof = profile_qp_solve(tf, theta, st, reps=3)
    print(f'# phase 18: profile_qp_solve, MPC per-instance B={B_MAIN}, K3 '
          'route: ' + ', '.join(f'{k} {v:.4f}' for k, v in prof.items())
          + f' [{card}]')
    check(all(math.isfinite(v) and v > 0 for v in prof.values()),
          f'profile: {prof}')
    # the device's busy share of the whole solve: its kernels' time in a
    # torch.profiler trace of one solve over the untraced solve's time
    solver = CompiledQPSolver(fam, settings=st)
    trace_dir = os.path.join(ROOT, 'build', 'chip_smoke', 'trace')
    with trace(trace_dir) as tr:
        solver.solve_batch(theta, shared_PA=False)
        torch.cuda.synchronize()
    # the kernels' own events (device type CUDA): an operator's event
    # carries its kernels' time too, so summing every event counts it twice
    kernels = [e for e in tr.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    k3_ms = sum(e.self_device_time_total for e in kernels
                if 'iterate_resident_kernel' in e.key
                or 'iterate_stream_kernel' in e.key) / 1e3
    busy = device_ms / prof['total_solve_ms']
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:4]
    print(f'# phase 18: trace of one solve ({trace_dir}/trace.json): '
          f'device time {device_ms:.3f} ms, {100 * busy:.1f}% of the '
          f'untraced {prof["total_solve_ms"]:.3f} ms (idle '
          f'{100 * (1 - busy):.1f}%); K3 kernels {k3_ms:.3f} ms; the '
          'largest: ' + '; '.join(
              f'{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms '
              f'({e.count})' for e in top))
    check(device_ms > 0, 'phase 18: the trace shows no device time')
    check(k3_ms > 0, 'phase 18: the trace shows no K3 kernel')
    return prof


def consensus_problem(ct, n=6, m=4):
    """tests/test_consensus.py::_family in the port's modeling layer."""
    G = np.random.default_rng(0).standard_normal((m, n))
    v = ct.Variable(n, name='v')
    c = ct.Parameter(n, name='c')
    d0 = ct.Parameter(m, name='d0')
    prob = ct.Problem(ct.Minimize(ct.sum_squares(v) + c @ v), [G @ v <= d0])
    c.value, d0.value = np.zeros(n), np.ones(m)
    return prob


def consensus_batch(fam, B, n=6, m=4, seed=3):
    """tests/test_consensus.py::_scenarios: c ~ N(0, 1), d0 = |N(0, 1)| + 1."""
    rng = np.random.default_rng(seed)
    cs = rng.standard_normal((B, n))
    ds = np.abs(rng.standard_normal((B, m))) + 1.0
    return np.stack([fam.pack_theta(values={'c': cs[b], 'd0': ds[b]})
                     for b in range(B)])


def _host(out):
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


def kernel_wrappers():
    """Every kernel wrapper of the port by kernel name, K1-K11 (each counts
    its launches in ``.launches``; K9 and K10 are the two wrappers of the
    one fused kernel)."""
    from cvxpygen_tpu_torch.ops import admm_full_kernel as k2
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    from cvxpygen_tpu_torch.ops import banded_shared_kernel as k45
    from cvxpygen_tpu_torch.ops import ldl_kernel as lk
    return dict(K1=k1.admm_shared_solve, K2=k2.admm_solve_full,
                K3=k3.admm_iterate, K4=k45.cr_solve,
                K5=k45.banded_shared_chunk, K6=lk.ldl_factor_kernel,
                K7=lk.ldl_inverse_kernel, K8=lk.ldl_solve_kernel,
                K9=lk.ldl_factor_inverse_kernel, K10=lk.ldl_kinv_kernel,
                K11=k45.banded_iterate)


def _counted(fn, warm=True):
    """fn() once to warm up (when ``warm``), then once more with every
    kernel's count set to 0 just before it and read just after: (output,
    seconds, launches by kernel name)."""
    wrappers = kernel_wrappers()
    if warm:
        fn()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (_host(out), time.perf_counter() - t0,
            {k: w.launches for k, w in wrappers.items()})


def _parallel_work(rank, world):
    """What each rank of phase 19 runs; rank 0 then runs the single-process
    references."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.parallel import (consensus_solve, make_mesh,
                                             sharded_solve)
    from cvxpygen_tpu_torch.parallel.mesh import make_sharded_qp_solve
    from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings

    prob = assign_mpc(mpc_problem(ct))
    fam = canonicalize(prob)
    theta = x_init_batch(fam, prob, RANK_B * world)
    cfam = canonicalize(consensus_problem(ct))
    ctheta = consensus_batch(cfam, RANK_B * world)
    sel = [('v', np.arange(CONSENSUS_K))]
    shared = CompiledQPSolver(fam, settings=ADMMSettings(**BENCH_SETTINGS))
    per = CompiledQPSolver(fam, settings=k3_route_settings())
    full = CompiledQPSolver(fam, settings=ADMMSettings(**GENERAL_SETTINGS))
    st_model = ADMMSettings(**dict(GENERAL_SETTINGS, use_pallas='never',
                                   ns_adapt_iters=12))
    mesh = make_mesh(axes=('batch',))
    res = dict(
        shared=_counted(lambda: sharded_solve(shared, theta, mesh)),
        per_instance=_counted(lambda: sharded_solve(per, theta, mesh,
                                                    shared_PA=False)),
        per_instance_small=_counted(lambda: sharded_solve(
            per, theta[:RANK_B_ROUTE * world], mesh, shared_PA=False)),
        full=_counted(lambda: sharded_solve(full, theta[:B_FULL], mesh,
                                            shared_PA=False)),
        consensus=_counted(lambda: consensus_solve(
            cfam, ctheta, sel, mesh=mesh, **CONSENSUS_SETTINGS)))
    try:
        consensus_solve(cfam, consensus_batch(cfam, RANK_B_SMALL * world),
                        sel, mesh=mesh, **CONSENSUS_SETTINGS)
        res['consensus_small'] = None
    except ValueError as e:
        res['consensus_small'] = str(e)
    mesh2 = make_mesh(axes=('batch', 'model'), shape=(1, world))
    model = make_sharded_qp_solve(shared.jf, mesh2, st_model)
    res['model'] = _counted(lambda: model(theta[:B_MODEL]), warm=False)
    if rank == 0:
        res['single'] = dict(
            shared=_counted(lambda: shared.solve_batch(theta)),
            per_instance=_counted(lambda: per.solve_batch(
                theta, shared_PA=False)),
            per_instance_small=_counted(lambda: per.solve_batch(
                theta[:RANK_B_ROUTE * world], shared_PA=False)),
            full=_counted(lambda: full.solve_batch(theta[:B_FULL],
                                                   shared_PA=False)),
            consensus=_counted(lambda: consensus_solve(
                cfam, ctheta, sel, **CONSENSUS_SETTINGS)),
            model=_counted(lambda: per.solve_batch(
                theta[:B_MODEL], settings=st_model, shared_PA=False),
                warm=False))
    return res


def parallel_rank(rank, world, backend, store_file, out_dir):
    """One rank of phase 19's world.  'gloo': every rank on cuda:0 (NCCL
    refuses two ranks on one card); 'nccl': rank r on cuda:r.  Writes its
    results to ``<out_dir>/rank<r>.pkl``."""
    import datetime
    import pickle
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    torch.cuda.set_device(rank if backend == 'nccl' else 0)
    dist.init_process_group(
        backend, store=dist.FileStore(store_file, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=PARALLEL_TIMEOUT_S // 2))
    try:
        res = _parallel_work(rank, world)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(res, f)


def x_gap(a, b):
    """Largest |a - b| per instance relative to max(1, |b|_inf)."""
    scale = np.maximum(1.0, np.max(np.abs(b), axis=1))
    return float(np.max(np.max(np.abs(a - b), axis=1) / scale))


def phase_parallel(card, world=PARALLEL_RANKS, backend='gloo'):
    """Phase 19: a ``world``-rank world through parallel/ (by default two
    gloo ranks on cuda:0; ``--nccl``: one NCCL rank per card): the shared
    MPC batch (K1 at the whole batch's rho group on each rank), the
    per-instance K3 route, the K2 route (K2 at the whole batch's block), the
    scenario consensus and a 1 x world model-axis solve, each against rank
    0's single-process run.  Returns K1's, K2's and K3's launches on the
    sharded runs (all ranks), by name."""
    import pickle
    import shutil
    out_dir = os.path.join(ROOT, 'build', 'chip_smoke', 'parallel')
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ctx = multiprocessing.get_context('spawn')
    t0 = time.perf_counter()
    procs = [ctx.Process(target=parallel_rank,
                         args=(r, world, backend,
                               os.path.join(out_dir, 'store'), out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(PARALLEL_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    check(all(p.exitcode == 0 for p in procs),
          f'phase 19: rank exit codes {[p.exitcode for p in procs]}')
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f'rank{r}.pkl'), 'rb') as f:
            ranks.append(pickle.load(f))
    single = ranks[0]['single']
    where = 'cuda:0' if backend == 'gloo' else f'cuda:0-{world - 1}'
    print(f'# phase 19: {world}-rank {backend} world on {where}, '
          f'{time.perf_counter() - t0:.1f} s with start-up [{card}]')
    from cvxpygen_tpu_torch.solvers.admm import pick_block
    B_route = RANK_B_ROUTE * world
    print(f'# phase 19: per_instance_small, B={B_route} ({RANK_B_ROUTE} a '
          "rank): the reference's block for the whole batch "
          f'{pick_block(B_route, 252, 222, torch.float32)}, for a rank '
          f'alone {pick_block(RANK_B_ROUTE, 252, 222, torch.float32)}')
    launches = dict(K1=0, K2=0, K3=0)
    for name, kernel in (('shared', 'K1'), ('per_instance', 'K3'),
                         ('per_instance_small', 'K3'), ('full', 'K2'),
                         ('consensus', 'K1'), ('model', None)):
        ref, t_ref, s_n = single[name]
        for r, res in enumerate(ranks):
            out, dt, n = res[name]
            for k in launches:
                launches[k] += n[k]
            counts = ', '.join(f'{k} {n[k]}' for k in launches)
            counts_ref = ', '.join(str(s_n[k]) for k in launches)
            if name == 'consensus':
                gap = float(np.max(np.abs(out['z_consensus']
                                          - ref['z_consensus'])))
                print(f'# phase 19: consensus B={RANK_B * world} rank {r}: '
                      f'outer iterations {out["outer_iters"]} (single '
                      f'{ref["outer_iters"]}), solved {out["solved"]}, '
                      f'residual {float(out["consensus_residual"]):.3e}, '
                      f'|zbar - single|_inf {gap:.3e}, x gap '
                      f'{x_gap(out["x"], ref["x"]):.3e}; {1e3 * dt:.3f} ms '
                      f'(single {1e3 * t_ref:.3f}), launches {counts} '
                      f'(single {counts_ref})')
                check(out['solved'] == ref['solved']
                      and out['outer_iters'] == ref['outer_iters']
                      and gap <= CONSENSUS_TOL,
                      f'consensus rank {r}: outer iterations '
                      f'{out["outer_iters"]} against {ref["outer_iters"]}, '
                      f'zbar gap {gap:.3e}')
                check(n['K1'] > 0, 'consensus: K1 was not launched')
                continue
            same = all(np.array_equal(out[k], ref[k]) for k in out)
            n_it = int(np.sum(out['iters'] != ref['iters']))
            gap = x_gap(out['x'], ref['x'])
            obj, obj_ref = out['obj'] + out['d'], ref['obj'] + ref['d']
            obj_gap = float(np.max(np.abs(obj - obj_ref)
                                   / np.maximum(1.0, np.abs(obj_ref))))
            print(f'# phase 19: {name} rank {r}: bitwise {same}, x gap '
                  f'{gap:.3e}, objective gap {obj_gap:.3e}, iterations '
                  f'differ on {n_it} of {len(ref["iters"])}, mean iters '
                  f'{float(np.mean(out["iters"])):.2f} (single '
                  f'{float(np.mean(ref["iters"])):.2f}), solved '
                  f'{float(np.mean(out["status"] == 1))}; {1e3 * dt:.3f} ms '
                  f'(single {1e3 * t_ref:.3f}); launches {counts} '
                  f'(single {counts_ref})')
            check(np.all(out['status'] == 1), f'{name} rank {r}: unsolved')
            check(n_it == 0 and gap <= SHARD_TOL,
                  f'{name} rank {r}: {n_it} iterations differ, x gap {gap}')
            check(kernel is None or n[kernel] > 0,
                  f'{name}: {kernel} was not launched')
            if name == 'per_instance_small':
                # the route is part of the answer: each rank decides it
                # from the whole batch, as one process does
                check(same and s_n['K3'] > 0,
                      f'{name} rank {r}: bitwise {same}, one process '
                      f'launched K3 {s_n["K3"]} times')
    msg = ranks[0]['consensus_small']
    small = RANK_B_SMALL * world
    print(f'# phase 19: consensus B={small} over {world} ranks raises: {msg}')
    check(msg is not None and f'({small} instances)' in msg
          and f'holds {RANK_B_SMALL}' in msg,
          f'consensus B={small}: no rho-group error')
    return launches


def run_exported(path, theta_file, out_file):
    """``--run-exported``: phase 20's fresh process.  Loads the program,
    solves theta (one warm-up call, then three timed by CUDA events, K3's
    launches counted) and saves the result; it builds no Family."""
    import gc
    sys.path.insert(0, ROOT)
    from cvxpygen_tpu_torch.canon.canonicalizer import Family
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.runtime.aot import load_exported
    t0 = time.perf_counter()
    call = load_exported(path)
    t_load = time.perf_counter() - t0
    theta = np.load(theta_file)
    t0 = time.perf_counter()
    call(theta)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    k3.admm_iterate.launches = 0
    reps = 3
    ms, out = cuda_ms(lambda: call(theta), reps)
    families = sum(type(o) is Family for o in gc.get_objects())
    x, _, obj, iters, solved = (t.cpu().numpy() for t in out)
    np.savez(out_file, x=x, obj=obj, iters=iters, solved=solved, ms=ms,
             launches=k3.admm_iterate.launches / reps, families=families,
             t_load=t_load, t_first=t_first)


def phase_aot(card):
    """Phase 20: the per-instance MPC solve (K3 route) exported at B=256,
    loaded and run in a fresh process, against the live solve.  Returns
    K3's launches of one exported call."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.ops import admm_kernel as k3
    from cvxpygen_tpu_torch.runtime.aot import export_qp_solver
    from cvxpygen_tpu_torch.runtime.solver import CompiledQPSolver
    prob = assign_mpc(mpc_problem(ct))
    fam = canonicalize(prob)
    st = k3_route_settings()
    solver = CompiledQPSolver(fam, settings=st)
    theta = x_init_batch(fam, prob, B_AOT)
    out_dir = os.path.join(ROOT, 'build', 'chip_smoke', 'aot')
    os.makedirs(out_dir, exist_ok=True)
    t0 = time.perf_counter()
    path, _ = export_qp_solver(solver.jf, B_AOT, st, cache_dir=out_dir)
    t_export = time.perf_counter() - t0
    solver.solve_batch(theta, shared_PA=False)
    k3.admm_iterate.launches = 0
    live_ms, live = cuda_ms(lambda: solver.solve_batch(theta,
                                                       shared_PA=False), 3)
    live_launches = k3.admm_iterate.launches / 3
    theta_file = os.path.join(out_dir, 'theta.npy')
    out_file = os.path.join(out_dir, 'exported.npz')
    np.save(theta_file, theta)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    '--run-exported', path, theta_file, out_file],
                   check=True, timeout=PARALLEL_TIMEOUT_S)
    t_load = time.perf_counter() - t0
    exp = np.load(out_file)
    live = _host(live)
    same = (np.array_equal(exp['x'], live['x'])
            and np.array_equal(exp['iters'], live['iters']))
    gap = x_gap(exp['x'], live['x'])
    n_it = int(np.sum(exp['iters'] != live['iters']))
    print(f'# phase 20: export MPC per-instance B={B_AOT} (K3 route) '
          f'{t_export:.1f} s -> {os.path.basename(path)}; fresh process '
          f'{t_load:.1f} s (load {float(exp["t_load"]):.1f} s, first call '
          f'{float(exp["t_first"]):.1f} s; Family objects there: '
          f'{int(exp["families"])}): '
          f'bitwise {same}, x gap {gap:.3e}, iterations differ on {n_it}, '
          f'solved {float(np.mean(exp["solved"]))}; exported '
          f'{float(exp["ms"]):.3f} ms per call, live {live_ms:.3f} ms; K3 '
          f'launches per call {float(exp["launches"]):.1f} (live '
          f'{live_launches:.1f}) [{card}]')
    check(int(exp['families']) == 0, 'the exported run built a Family')
    check(bool(np.all(exp['solved'])) and n_it == 0 and gap <= SHARD_TOL,
          f'exported solve: {n_it} iterations differ, x gap {gap:.3e}')
    check(np.array_equal(exp['solved'], live['solved']), 'solved differs')
    check(float(exp['launches']) > 0, 'the exported program launched no K3')
    return int(round(float(exp['launches'])))


# ---------------------------------------------------------------------------
# phase 21: the embedded-C artifact (native/, codegen/emit_c.py)
# ---------------------------------------------------------------------------

# instances of the shared MPC batch the embedded core solves on the host,
# at its eps (the dense core's float64 solve against K1's float32 one)
N_NATIVE = 64
NATIVE_EPS = 1e-6
NATIVE_MAX_ITER = 20000
# the C example's printed dobj/dtheta (9 significant digits) against
# NativeQPSolver.gradient on the same family, theta and settings
NATIVE_GRAD_TOL = 1e-6
# the charging family and banded settings of tests/test_native.py:379-417
# (the JAX package's artifact test): T=1440 gets the sparse COO + RCM-banded
# emission; at eps 1e-3 the banded engine alone sits up to 1.04e-2 from
# the optimum (ROADMAP A3), so it is held at 1e-4
NATIVE_CHARGING_SETTINGS = dict(eps_abs=1e-4, eps_rel=1e-4, max_iter=200000,
                                check_interval=50)
C_EXAMPLE_TIMEOUT_S = 300


def native_charging_problem(ct, T=CHARGING_T):
    """The charging family of tests/test_admm_banded.py:23-40 (seed 0)."""
    u = ct.Variable(T, name='u')
    qv = ct.Variable(T + 1, name='q')
    p = ct.Parameter(T, nonneg=True, name='p')
    gamma = ct.Parameter(nonneg=True, name='gamma')
    objective = ct.Minimize(p @ u + gamma * ct.sum_squares(u))
    constraints = [qv[1:] == qv[:-1] + u,
                   ct.Constant(-0.1) <= u, u <= ct.Constant(0.05),
                   ct.Constant(0) <= qv, qv <= ct.Constant(1.0),
                   qv[0] == 0, qv[T] == ct.Constant(1.0)]
    prob = ct.Problem(objective, constraints)
    p.value = 1.0 + 4.0 * np.random.default_rng(0).random(T)
    gamma.value = 50.0
    return prob


def host_cpu():
    """The host CPU as /proc/cpuinfo gives it (its model name and vendor;
    a virtual machine may report the name as unknown) and the logical
    CPUs this process may use."""
    fields = {}
    with open('/proc/cpuinfo') as f:
        for line in f:
            key, _, value = line.partition(':')
            fields.setdefault(key.strip(), value.strip())
    return (f"{fields.get('model name', 'no model name')} "
            f"({fields.get('vendor_id', 'no vendor_id')}, cpu family "
            f"{fields.get('cpu family', '?')} model "
            f"{fields.get('model', '?')}), "
            f'{len(os.sched_getaffinity(0))} logical CPUs')


def build_c_project(cdir):
    """Build a generated c/ with ``make``, as its Makefile says.  Returns
    (what ran, seconds)."""
    check(shutil.which('make') is not None,
          'make is not on PATH: it builds the generated c/ projects')
    t0 = time.perf_counter()
    res = subprocess.run(['make'], cwd=cdir, capture_output=True, text=True)
    check(res.returncode == 0, f'make in {cdir} failed:\n'
          + res.stdout + res.stderr)
    return 'make', time.perf_counter() - t0


def run_c_example(cdir):
    """./cpg_example: (status, iterations, objective, printed gradient
    entries, seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run(['./cpg_example'], cwd=cdir, capture_output=True,
                         text=True, timeout=C_EXAMPLE_TIMEOUT_S)
    dt = time.perf_counter() - t0
    out = res.stdout
    check(res.returncode == 0, f'{cdir}/cpg_example failed:\n{out}'
          + res.stderr)
    head = re.search(r'status = (-?\d+), iters = (\d+), obj = (\S+)', out)
    check(head is not None, f'{cdir}/cpg_example printed:\n{out}')
    grads = [float(v) for v in
             re.findall(r'dobj/dtheta\[\d+\] = (\S+)', out)]
    return (int(head.group(1)), int(head.group(2)), float(head.group(3)),
            grads, dt)


def timed_native_build():
    from cvxpygen_tpu_torch import native
    t0 = time.perf_counter()
    native.get_lib()
    return time.perf_counter() - t0


def phase_embedded(card, dev='cuda'):
    """Phase 21: the embedded-C artifact.  Returns K1's and K4's launches
    (the shared MPC batch and the banded charging solve)."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch import cpg
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.native import NativeQPSolver
    from cvxpygen_tpu_torch.ops import admm_shared_kernel as k1
    from cvxpygen_tpu_torch.ops import banded_shared_kernel as k45
    from cvxpygen_tpu_torch.runtime.solver import (CompiledBandedQPSolver,
                                                   CompiledQPSolver)
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    host = host_cpu()
    base = os.path.join(ROOT, 'build', 'chip_smoke', 'embedded')

    # the packages: MPC H=10 at the default device with gradient=True, and
    # charging T=1440 (sparse emission)
    prob = assign_mpc(mpc_problem(ct))
    mpc_dir = os.path.join(base, 'mpc_code')
    cpg.generate_code(prob, code_dir=mpc_dir, solver='ADMM', gradient=True,
                      device=None if dev == 'cuda' else dev)
    cprob = native_charging_problem(ct)
    ch_dir = os.path.join(base, 'charging_code')
    cpg.generate_code(cprob, code_dir=ch_dir, wrapper=False)
    with open(os.path.join(ROOT, 'LICENSE'), 'rb') as f:
        lic = f.read()
    with open(os.path.join(mpc_dir, 'LICENSE'), 'rb') as f:
        check(f.read() == lic, 'the package LICENSE differs from the repo')
    with open(os.path.join(mpc_dir, 'README.html')) as f:
        html = f.read()
    for name in ('Psqrt', 'Qsqrt', 'Rsqrt', 'A', 'B', 'x_init', 'U', 'X',
                 'cpg_core.cpp', 'c/ (make && ./cpg_example)'):
        check(name in html, f'README.html lacks {name}')
    with open(os.path.join(ch_dir, 'c', 'cpg_data.c')) as f:
        src = f.read()
    check('cpg_native_set_scatter' in src and 'cpg_native_set_perm' in src,
          'charging T=1440 did not get the sparse emission')

    # the ctypes library and both c/ projects, built at once
    with ThreadPoolExecutor(3) as ex:
        f_lib = ex.submit(timed_native_build)
        f_mpc = ex.submit(build_c_project, os.path.join(mpc_dir, 'c'))
        f_ch = ex.submit(build_c_project, os.path.join(ch_dir, 'c'))
        t_lib, (how, t_mpc), (_, t_ch) = (f_lib.result(), f_mpc.result(),
                                          f_ch.result())
    print(f'# phase 21: builds at once: ctypes library (g++ -O3 '
          f'-march=native) {t_lib:.2f} s; c/ by `{how}`: MPC {t_mpc:.2f} s, '
          f'charging T={CHARGING_T} {t_ch:.2f} s [host {host}]')

    # (a) MPC: the C example against solve(method='CPG') on the card, the
    # float64 oracle and the ctypes core's gradient
    status, iters, obj_c, grads, t_run = run_c_example(
        os.path.join(mpc_dir, 'c'))
    check(status == 1, f'MPC cpg_example status {status}')
    val_cpg = prob.solve(method='CPG')
    fam = canonicalize(prob)
    theta0 = fam.pack_theta(params=prob.parameters())
    obj_oracle = oracle_objs(fam, theta0[None], 1)[0]
    rel_cpg = abs(obj_c - val_cpg) / max(1.0, abs(val_cpg))
    rel_oracle = abs(obj_c - obj_oracle) / max(1.0, abs(obj_oracle))
    ns = NativeQPSolver(fam)
    res = ns.solve(theta0)
    g = ns.gradient(gobj=1.0)
    check(len(grads) == min(4, fam.p), f'{len(grads)} gradient entries')
    g_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(grads, g))
    print(f'# phase 21: MPC H=10 c/ example: status {status}, {iters} iters '
          f'(ctypes core {res["iters"]}), objective {obj_c:.9g}; rel to '
          f'solve(method=CPG) on the card ({val_cpg:.6f}) {rel_cpg:.3e}, to '
          f'the float64 oracle ({obj_oracle:.6f}) {rel_oracle:.3e}; dobj/'
          f'dtheta[:{len(grads)}] rel to NativeQPSolver.gradient {g_err:.3e}; '
          f'run {1e3 * t_run:.1f} ms [host {host}; {card}]')
    check(rel_cpg <= PARITY_BAR and rel_oracle <= PARITY_BAR,
          f'MPC C objective rel {rel_cpg:.3e} / {rel_oracle:.3e}')
    check(g_err <= NATIVE_GRAD_TOL, f'MPC C gradient rel {g_err:.3e}')

    # (b) K1 on the shared batch of phase 3 against the embedded core
    theta = x_init_batch(fam, prob, B_MAIN)
    solver = CompiledQPSolver(fam, settings=ADMMSettings(**BENCH_SETTINGS),
                              device=dev)
    k1.admm_shared_solve.launches = 0
    out = solver.solve_batch(theta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solver.solve_batch(theta)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    k1_launches = k1.admm_shared_solve.launches
    check(k1_launches > 0, 'the shared batch did not launch K1')
    check(bool((out['status'] == 1).all()), 'K1 left instances unsolved')
    obj = (out['obj'] + out['d']).double().cpu().numpy()
    ns.set_settings(eps_abs=NATIVE_EPS, eps_rel=NATIVE_EPS,
                    max_iter=NATIVE_MAX_ITER)
    t0 = time.perf_counter()
    nat = [ns.solve(theta[i]) for i in range(N_NATIVE)]
    t_native = (time.perf_counter() - t0) / N_NATIVE
    check(all(r['solved'] for r in nat), 'the embedded core left instances '
          'unsolved')
    max_rel, n_bad = parity(obj, [r['obj'] for r in nat])
    print(f'# phase 21: K1 B={B_MAIN}: {1e3 * dt:.3f} ms per batch, K1 '
          f'launches {k1_launches} (two calls) [{card}]; objective on '
          f'{N_NATIVE} within {max_rel:.3e} of NativeQPSolver at eps '
          f'{NATIVE_EPS:g} (mean iters '
          f'{np.mean([r["iters"] for r in nat]):.1f}, '
          f'{1e3 * t_native:.3f} ms per solve on the host [{host}])')
    check(n_bad == 0 and max_rel <= PARITY_BAR,
          f'K1 against the embedded core {max_rel:.3e} ({n_bad} non-finite)')

    # (c) charging T=1440: the sparse C example against the banded engine
    # (K4) on the card at eps 1e-4
    status, iters, obj_c, _, t_run = run_c_example(os.path.join(ch_dir, 'c'))
    check(status == 1, f'charging cpg_example status {status}')
    cfam = canonicalize(cprob)
    ctheta = cfam.pack_theta(params=cprob.parameters())
    csolver = CompiledBandedQPSolver(
        cfam, settings=ADMMSettings(**NATIVE_CHARGING_SETTINGS), device=dev)
    k45.cr_solve.launches = 0
    t0 = time.perf_counter()
    cout = csolver.solve_batch(ctheta[None, :])
    torch.cuda.synchronize()
    t_banded = time.perf_counter() - t0
    k4_launches = k45.cr_solve.launches
    check(bool(cout['solved'][0]), 'the banded engine did not solve charging')
    obj_b = float((cout['obj'] + cout['d'])[0])
    rel = abs(obj_c - obj_b) / max(1.0, abs(obj_b))
    print(f'# phase 21: charging T={CHARGING_T} c/ example (sparse COO + '
          f'RCM-banded core): status {status}, {iters} iters, objective '
          f'{obj_c:.9g}, run {1e3 * t_run:.1f} ms [host {host}]; banded '
          f'engine at eps {NATIVE_CHARGING_SETTINGS["eps_abs"]:g}: '
          f'{obj_b:.9g} (rel {rel:.3e}), {int(cout["iters"][0])} iters, '
          f'{1e3 * t_banded:.1f} ms, K4 launches {k4_launches} [{card}]')
    check(k4_launches > 0, 'the banded charging solve did not launch K4')
    check(rel <= PARITY_BAR, f'charging C objective rel {rel:.3e}')
    return k1_launches, k4_launches


# phase 22: float64 on the card through the default routes
B_F64 = 64
N_ORACLE_F64 = 16
F64_SETTINGS = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000,
                    check_interval=25, adaptive_rho=True)
F64_CPG_SETTINGS = dict(eps_abs=1e-6, eps_rel=1e-6, max_iter=20000)
# the bars of the port's CPU float64 tests for each family: the objective
# within 1e-6 of the oracle relative to max(1, |ref|) (MPC:
# tests/test_torch_solver.py::_assert_same_solution; ADP:
# tests/test_torch_ipm_socp.py::test_adp_generate_code_default_ipm_matches_oracle);
# entropy's objective within 1e-7 of logsumexp(c) and x within 1e-5 of
# softmax(c) (tests/test_torch_ipm.py::test_entropy_default_scaling_reaches_optimum)
F64_ORACLE_TOL = 1e-6
F64_ENTROPY_OBJ_TOL = 1e-7
F64_ENTROPY_X_TOL = 1e-5
# the card's float64 run against the port's CPU float64 run of the same
# route: equal statuses, iterations within one check interval (the IPM
# checks every iteration), x within 1e-6 (x_gap)
F64_CPU_TOL = 1e-6
# entropy with the dual-barrier scaling and no neighbourhood backtracking,
# where the IPM's path is a smooth function of the data (ROADMAP A4): with
# the default two-secant scaling a 1e-15 relative change of c moved one
# instance of this batch by 28 iterations in a CPU float64 run
F64_ENTROPY_SETTINGS = dict(exotic_scaling='dual', exotic_backtracks=0)
# timed calls of each float64 route after its first (set-up) call
F64_REPS = 2
# MPC H=30 on the banded engine: float64 on the card takes the per-instance
# banded engine (the shared one runs K4/K5); at eps 1e-6 its objective is
# held within the 1e-3 of tests/test_torch_banded.py::
# test_generate_code_banded_cpg_solve (2.9e-6 in a CPU float64 run)
B_F64_BANDED = 2
F64_BANDED_SETTINGS = dict(MPC30_SETTINGS, eps_abs=1e-6, eps_rel=1e-6,
                           max_iter=20000)
F64_BANDED_ORACLE_TOL = 1e-3


@contextlib.contextmanager
def one_cpu_thread():
    """The CPU yardsticks run on one thread: their answer then does not
    depend on how the host splits a product."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def f64_against_cpu(label, out, ref, interval):
    """Hold the card's float64 result to the CPU float64 run of the same
    route (host dicts): equal statuses, iterations within ``interval``, x
    within F64_CPU_TOL.  Returns the printed summary."""
    n_status = int(np.sum(out['status'] != ref['status']))
    d_it = int(np.max(np.abs(out['iters'].astype(np.int64)
                             - ref['iters'].astype(np.int64))))
    gap = x_gap(out['x'], ref['x'])
    check(n_status == 0 and d_it <= interval and gap <= F64_CPU_TOL,
          f'{label}: against the CPU float64 run, {n_status} statuses '
          f'differ, iterations by {d_it} (bar {interval}), x gap {gap:.3e}')
    return (f'against the CPU float64 run: statuses equal, iterations '
            f'within {d_it}, x gap {gap:.3e}')


def phase_float64(card, dev='cuda'):
    """Phase 22: float64 on the card through the default routes, B_F64
    instances each.  The kernels take float32, so float64 takes the
    reference's routes off its TPU: MPC H=10 through generate_code(dtype=
    'float64') -> solve_batch (the shared torch loop, no K1), one
    solve(method='CPG'), MPC general on the per-instance loop (no K3, whose
    float32 route takes this B), ADP and entropy n=32 on the IPM at 'auto'
    ('lu', no K6/K7), MPC H=30 through CompiledBandedQPSolver at
    B_F64_BANDED (the per-instance banded engine, no K4/K5); each against
    the float64 oracle (or logsumexp) at the bar of the port's CPU float64
    tests and against the port's CPU float64 run of the same route.  No
    kernel may launch in the phase.  Each route is timed by
    ``timed_solve`` after its first call.  Then the banded shared engine on
    charging T=1440 in float64 must raise its ValueError at entry, and
    CompiledBandedQPSolver must route that batch to the per-instance
    engine instead."""
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch import cpg
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.runtime.solver import (CompiledBandedQPSolver,
                                                   CompiledConicSolver,
                                                   CompiledQPSolver)
    from cvxpygen_tpu_torch.runtime.torch_family import (canon_batch_sparse,
                                                         qp_bounds_batch)
    from cvxpygen_tpu_torch.solvers import admm_banded_shared, ipm
    from cvxpygen_tpu_torch.solvers.admm import (ADMMSettings, pick_block,
                                                 use_iterate_kernel)
    f64 = torch.float64
    t_phase = time.perf_counter()
    counters = kernel_wrappers()
    for w in counters.values():
        w.launches = 0

    # MPC H=10: the generated package in float64, its batch (shared P/A)
    prob = assign_mpc(mpc_problem(ct))
    val_oracle = prob.solve()
    mod = cpg.generate_code(
        prob, code_dir=os.path.join(ROOT, 'build', 'chip_smoke', 'mpc_f64'),
        solver='ADMM', dtype='float64', device=dev)
    rt = mod._runtime
    solver = rt.solver
    fam = solver.family
    check(solver.jf.maps.dtype == f64 and solver.device.type == dev,
          f'float64 package: {solver.jf.maps.dtype} on {solver.device}')
    theta = x_init_batch(fam, prob, B_F64)
    refs = oracle_objs(fam, theta, N_ORACLE_F64)
    st = ADMMSettings(**F64_SETTINGS)
    # the card's 'auto' KKT mode is 'ns'; the CPU run pins it
    st_cpu = dataclasses.replace(st, kkt_solver='ns')
    cpu = CompiledQPSolver(fam, settings=st_cpu, dtype=f64, device='cpu')
    for label, shared in (('shared', 'auto'), ('per-instance', False)):
        out, sec = timed_solve(solver, theta, st, F64_REPS, shared_PA=shared)
        out = _host(out)
        with one_cpu_thread():
            ref = _host(cpu.solve_batch(theta, shared_PA=shared))
        max_rel, n_bad = parity(out['obj'] + out['d'], refs)
        vs_cpu = f64_against_cpu(f'MPC {label}', out, ref,
                                 st.check_interval)
        k3 = [use_iterate_kernel(st, 'ns', B_F64, fam.m, fam.n, dt,
                                 solver.device) for dt in (torch.float32, f64)]
        route = ('' if shared else '; K3 route in float32 at this B: '
                 f'{k3[0]} (block '
                 f'{pick_block(B_F64, fam.m, fam.n, torch.float32)}), in '
                 f'float64: {k3[1]}')
        print(f'# phase 22: MPC H=10 float64 {label}, B={B_F64}, eps 1e-6: '
              f'solved {float(np.mean(out["status"] == 1))}, mean iters '
              f'{float(np.mean(out["iters"])):.2f}, {1e3 * sec:.3f} ms a '
              f'call (mean of {F64_REPS} after the first); oracle parity on '
              f'{N_ORACLE_F64}: max rel {max_rel:.3e}; {vs_cpu}{route} '
              f'[{card}]')
        check(np.all(out['status'] == 1), f'MPC {label}: unsolved')
        check(n_bad == 0 and max_rel <= F64_ORACLE_TOL,
              f'MPC {label}: oracle parity {max_rel:.3e}')

    # one solve(method='CPG') of the float64 package (B=1: the loop), cold
    # as the CPU run is: a first call takes the set-up, the second is timed
    cpg_kw = dict(F64_CPG_SETTINGS, warm_start=False)
    prob.solve(method='CPG', **cpg_kw)
    t0 = time.perf_counter()
    val = prob.solve(method='CPG', **cpg_kw)
    ms = 1e3 * (time.perf_counter() - t0)
    rel = abs(val - val_oracle) / max(1.0, abs(val_oracle))
    st_cpg = dataclasses.replace(rt._settings(dict(cpg_kw)),
                                 kkt_solver='ns')
    with one_cpu_thread():
        ref = _host(cpu.solve_batch(
            fam.pack_theta(params=prob.parameters())[None], settings=st_cpg))
    vs_cpu = f64_against_cpu('MPC CPG', rt._ctx['out'], ref,
                             st_cpg.check_interval)
    print(f'# phase 22: MPC H=10 float64 solve(method=CPG): {prob.status}, '
          f'{prob.solver_stats.num_iters} iters, objective {val:.9f} vs '
          f'oracle {val_oracle:.9f} (rel {rel:.3e}), {ms:.3f} ms (the call '
          f'after the first); {vs_cpu} [{card}]')
    check(prob.status == 'optimal' and rel <= F64_ORACLE_TOL,
          f'MPC CPG float64: {prob.status}, rel {rel:.3e}')

    # the IPM at 'auto': ADP (P > 0, SOC) and entropy (exp cones, P = 0)
    aprob = assign_adp(adp_problem(ct))
    afam = canonicalize(aprob)
    atheta = adp_batch(afam, aprob, B_F64)
    arefs = oracle_objs(afam, atheta, N_ORACLE_F64)
    eprob, c = entropy_problem(ct, ENTROPY_N)
    cs = np.random.default_rng(5).normal(size=(B_F64, ENTROPY_N))
    c.value = cs[0]
    efam = canonicalize(eprob)
    etheta = entropy_batch(efam, eprob, cs)
    lse = np.log(np.sum(np.exp(cs), axis=1))
    est = ipm.IPMSettings(**F64_ENTROPY_SETTINGS)
    for name, pfam, th, settings in (('ADP', afam, atheta, None),
                                     ('entropy', efam, etheta, est)):
        isolver = CompiledConicSolver(pfam, settings=settings, dtype=f64,
                                      device=dev)
        exotic = bool(pfam.n_exp)
        mode = ipm.kkt_mode_for(isolver.settings, exotic, isolver.P_is_zero,
                                f64, isolver.device)
        mode32 = ipm.kkt_mode_for(isolver.settings, exotic,
                                  isolver.P_is_zero, torch.float32,
                                  isolver.device)
        out, sec = timed_solve(isolver, th, None, F64_REPS)
        out = _host(out)
        with one_cpu_thread():
            ref = _host(CompiledConicSolver(
                pfam, settings=settings, dtype=f64,
                device='cpu').solve_batch(th))
        vs_cpu = f64_against_cpu(name, out, ref, 1)
        if name == 'ADP':
            err, n_bad = parity(out['obj'] + out['d'], arefs)
            what = f'oracle parity on {N_ORACLE_F64}: max rel {err:.3e}'
            ok = n_bad == 0 and err <= F64_ORACLE_TOL
        else:
            xv = [v for v in pfam.user_vars if v.name == 'x'][0]
            sm = np.exp(cs) / np.sum(np.exp(cs), axis=1, keepdims=True)
            x_err = float(np.max(np.abs(
                out['x'][:, xv.offset:xv.offset + ENTROPY_N] - sm)))
            err = float(np.max(np.abs(-(out['obj'] + out['d']) - lse)))
            what = (f'|objective - logsumexp(c)| {err:.3e}, |x - '
                    f'softmax(c)| {x_err:.3e}')
            ok = err <= F64_ENTROPY_OBJ_TOL and x_err <= F64_ENTROPY_X_TOL
        print(f'# phase 22: {name} float64 on the IPM, B={B_F64}, '
              f"kkt_solver 'auto' -> {mode!r} (float32: {mode32!r}): solved "
              f'{float(np.mean(out["status"] == 1))}, mean iters '
              f'{float(np.mean(out["iters"])):.2f}, {1e3 * sec:.3f} ms a '
              f'call (mean of {F64_REPS} after the first); {what}; {vs_cpu} '
              f'[{card}]')
        check(mode == 'lu', f'{name}: float64 on the card takes {mode!r}')
        check(np.all(out['status'] == 1), f'{name} float64: unsolved')
        check(ok, f'{name} float64: {what}')

    # MPC H=30 through CompiledBandedQPSolver in float64: its batch shares
    # P/A, which in float32 takes the shared engine (K5); float64 takes the
    # per-instance banded engine, held to that engine's CPU float64 run
    mprob = assign_mpc(mpc_problem(ct, H=30))
    mfam = canonicalize(mprob)
    mtheta = x_init_batch(mfam, mprob, B_F64_BANDED)
    mrefs = oracle_objs(mfam, mtheta, B_F64_BANDED)
    mst = ADMMSettings(**F64_BANDED_SETTINGS)
    bsolver = CompiledBandedQPSolver(mfam, settings=mst, dtype=f64,
                                     device=dev)
    shared32 = CompiledBandedQPSolver(mfam, settings=mst,
                                      device=dev)._use_shared(mtheta, 'auto')
    shared64 = bsolver._use_shared(mtheta, 'auto')
    out, sec = timed_solve(bsolver, mtheta, None, F64_REPS)
    out = _host(out)
    with one_cpu_thread():
        ref = _host(CompiledBandedQPSolver(
            mfam, settings=mst, dtype=f64, device='cpu').solve_batch(
                mtheta, shared_PA=False))
    max_rel, n_bad = parity(out['obj'] + out['d'], mrefs)
    vs_cpu = f64_against_cpu('MPC H=30 banded', out, ref,
                             mst.check_interval)
    print(f'# phase 22: MPC H=30 float64 through CompiledBandedQPSolver, '
          f'B={B_F64_BANDED}, eps 1e-6: shared engine in float32 '
          f'{shared32}, in float64 {shared64}; solved '
          f'{float(np.mean(out["status"] == 1))}, iters '
          f'{out["iters"].tolist()}, {1e3 * sec:.3f} ms a call (mean of '
          f'{F64_REPS} after the first); oracle parity: max rel '
          f'{max_rel:.3e}; {vs_cpu} [{card}]')
    check(shared32 and not shared64,
          f'MPC H=30: shared engine in float32 {shared32}, float64 '
          f'{shared64}')
    check(np.all(out['status'] == 1), 'MPC H=30 float64: unsolved')
    check(n_bad == 0 and max_rel <= F64_BANDED_ORACLE_TOL,
          f'MPC H=30 float64: oracle parity {max_rel:.3e}')

    launches = {k: w.launches for k, w in counters.items()}
    print(f'# phase 22: kernel launches in the float64 runs: {launches}')
    check(not any(launches.values()),
          f'phase 22: a kernel launched in float64: {launches}')

    # charging T=1440 in float64: the banded shared engine has no route
    # without its kernels, so it raises at entry; the compiled solver takes
    # the per-instance engine instead (the reference's route off its TPU)
    cprob = charging_problem(ct)
    cfam = canonicalize(cprob)
    csolver = CompiledBandedQPSolver(cfam, dtype=f64, device=dev)
    ctheta = charging_batch(cfam, cprob, 2)
    data = canon_batch_sparse(csolver.jf, ctheta)
    l, u = qp_bounds_batch(csolver.jf, data['b'])
    try:
        admm_banded_shared.admm_solve_banded_shared(
            csolver.struct, csolver.grouped, data['pvals'][0], data['q'],
            data['avals'][0], l, u, cfam.n_zero,
            ADMMSettings(**CHARGING_SETTINGS), index=csolver.index)
        msg = None
    except ValueError as e:
        msg = str(e)
    shared = csolver._use_shared(ctheta, 'auto')
    print(f'# phase 22: charging T={CHARGING_T} float64 on the banded '
          f'shared engine raises: {msg}; the compiled solver takes the '
          f'shared engine: {shared}; phase {time.perf_counter() - t_phase:.1f}'
          f' s [{card}]')
    check(msg is not None and 'float64' in msg and 'K4' in msg,
          f'charging float64: the banded shared engine gave {msg!r}')
    check(not shared, 'charging float64 would take the banded shared engine')


def main():
    if not torch.cuda.is_available():
        sys.exit('chip_smoke.py: no CUDA device')
    sys.path.insert(0, ROOT)
    import cvxpygen_tpu_torch as ct
    from cvxpygen_tpu_torch.canon.canonicalizer import canonicalize
    from cvxpygen_tpu_torch.solvers.admm import ADMMSettings
    t_start = time.perf_counter()
    if sys.argv[1:2] == ['--run-exported']:
        run_exported(*sys.argv[2:5])
        return
    card = phase_build()
    if sys.argv[1:] == ['--block-sweep']:
        block_sweep(card)
        return
    if sys.argv[1:] == ['--nccl']:
        phase_parallel(card, torch.cuda.device_count(), 'nccl')
        return
    k1_numbers = phase_kernels(card)
    k1_launches, refs = phase_main_path(card, k1_numbers['ms'])
    prob = assign_mpc(mpc_problem(ct))
    fam = canonicalize(prob)
    st = ADMMSettings(**GENERAL_SETTINGS)
    portfolio = portfolio_batch()
    k3_numbers = compare_k3(fam, prob, st, card, portfolio)
    k2_numbers = compare_k2(fam, prob, st, card, portfolio)
    k2_launches, k3_launches = phase_per_instance(fam, prob, refs, card,
                                                  portfolio)
    k4_numbers, k4_launches, k5_numbers, k5_launches = phase_banded(card)
    ldl_numbers, ldl_launches, fused_numbers, fused_launches = \
        phase_conic(card)
    k11_numbers, k11_launches = phase_iterate(card)
    phase_conic_admm(card)
    # the layers' K1 launches join the shared main path's (phase 3), the
    # conic layer's K6 and K7 launches the IPM's (phase 11)
    k1_launches += phase_diff(card)
    diff_launches = phase_conic_diff(card)
    k1_launches += diff_launches['admm_shared_solve']
    for name in ('ldl_factor', 'ldl_inverse'):
        ldl_launches[name] += diff_launches[name]
    phase_explicit(card)
    phase_profile(card)
    par = phase_parallel(card)
    k1_launches += par['K1']
    k2_launches += par['K2']
    k3_launches += par['K3'] + phase_aot(card)
    native_k1, native_k4 = phase_embedded(card)
    k1_launches += native_k1
    k4_launches += native_k4
    phase_float64(card)
    kernels = [
        dict(name='admm_shared_solve', route='cuda',
             source='cvxpygen_tpu_torch/csrc/admm_shared.cu',
             replaces='cvxpygen_tpu/ops/admm_shared_kernel.py:51',
             launches=k1_launches, library_ms=None, **k1_numbers),
        dict(name='admm_solve_full', route='cuda',
             source='cvxpygen_tpu_torch/csrc/admm_full.cu',
             replaces='cvxpygen_tpu/ops/admm_full_kernel.py:42',
             launches=k2_launches, library_ms=None, **k2_numbers),
        dict(name='admm_iterate', route='cuda',
             source='cvxpygen_tpu_torch/csrc/admm_iterate.cu',
             replaces='cvxpygen_tpu/ops/admm_kernel.py:25',
             launches=k3_launches, library_ms=None, **k3_numbers),
        dict(name='cr_solve', route='cuda',
             source='cvxpygen_tpu_torch/csrc/cr_solve.cu',
             replaces='cvxpygen_tpu/ops/banded_shared_kernel.py:132',
             launches=k4_launches, **k4_numbers),
        dict(name='banded_shared_chunk', route='cuda',
             source='cvxpygen_tpu_torch/csrc/banded_chunk.cu',
             replaces='cvxpygen_tpu/ops/banded_shared_kernel.py:173',
             launches=k5_launches, **k5_numbers)]
    for name, src, line in (('ldl_factor', 'ldl_factor.cu', 77),
                            ('ldl_inverse', 'ldl_inverse.cu', 237),
                            ('ldl_solve', 'ldl_solve.cu', 106)):
        kernels.append(dict(
            name=name, route='cuda',
            source=f'cvxpygen_tpu_torch/csrc/{src}',
            replaces=f'cvxpygen_tpu/ops/ldl_kernel.py:{line}',
            launches=ldl_launches[name], **ldl_numbers[name]))
    # K9 and K10: one fused kernel behind two wrappers
    for name, line in (('ldl_factor_inverse', 441), ('ldl_kinv', 334)):
        kernels.append(dict(
            name=name, route='cuda',
            source='cvxpygen_tpu_torch/csrc/ldl_kinv.cu',
            replaces=f'cvxpygen_tpu/ops/ldl_kernel.py:{line}',
            launches=fused_launches[name], **fused_numbers[name]))
    kernels.append(dict(
        name='banded_iterate', route='cuda',
        source='cvxpygen_tpu_torch/csrc/banded_iterate.cu',
        replaces='cvxpygen_tpu/ops/banded_shared_kernel.py:511',
        launches=k11_launches, **k11_numbers))
    check(len(kernels) == 11, f'{len(kernels)} kernels in the line')
    print(f'# chip_smoke.py: all phases {time.perf_counter() - t_start:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
