#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (pyscf_mpcc_tpu_torch) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ops/csrc (one nvcc process
each, started together), then runs:

  0. environment: versions, card, TF32 flags (asserted off), whether
     torch.einsum may reorder contractions (opt_einsum), kernel builds
     and their register reports;
  1. the (T) epilogue kernel (triples_combine) against its plain PyTorch
     version on the card: random small problems in fp64 (staged and
     unstaged forms), every tile of a random problem at phase 17's nocc
     21 with a ragged nvir (19 at tile 8) in fp32 and fp64, and one tile
     at the (H2O)8 shape in fp32, with timings and the split of a cell's
     time by phase (the kernel's profile form);
  2. pinned H2O/cc-pVDZ energies in fp64 on the card (incore integrals):
     E(CCSD) and E(T), the latter through the CUDA kernel;
  3. the DF main path through the user entry points,
     RHF(mol).density_fit().run() -> CCSD(mf, device=cuda).run()
     -> .ccsd_t(), in fp32, against the same calls in fp64;
  4. the (H2O)8/cc-pVTZ frozen-core shape (nocc=32, nvir=424,
     naux=1216) with synthetic DF integrals: CCSD sweep time, rate and
     peak memory, an fp32-vs-fp64 sweep check, and a 64-tile (T) probe
     on the fused engine, and the same probe at chunk=4 (four tiles a
     launch of the epilogue kernel) with the kernel alone timed at K=4
     against K=1;
  5. the resident (T) engine (triples_resident, W1 dots in the kernel;
     modes split and bf16 on wgmma with operands split into bf16 once by
     the prep, mode f32 on FFMA): (a) the kernel against its plain
     version on random problems (fp64 mode f32, fp32 modes split and
     bf16), (b) one (H2O)8 tile in modes f32, split and bf16 through the
     prep of each mode: the kernel's time, its W1 share (its time less
     its time with F cut to one k-chunk of the mode) and W1 rate, the
     path's time, the one-time cost of splitting t2, beside the fused
     engine's path, (c) the pinned fp64 E(T) through engine='resident',
     (d) the 64-tile probe through engine='resident' in modes f32, split
     (through engine='auto', which routes dot_precision='high' there) and
     bf16, beside phase 4's;
  6. the (T) design probes (pyscf_mpcc_tpu_torch/tools): p1-p4 of
     triples_probe_v6 and the slab relayout at the JAX scripts' own
     shapes through their entry points, then each of their five kernels
     against its plain version (dispatch, smem and slab exact; dots rtol
     1e-5 on random inputs in each mode; stream fp64 sums rtol 1e-10),
     with its time, the plain version's, a library call's and the bound
     (the largest of bytes, operations and the launch floor, p1's
     graph-replayed empty kernel).  The dots kernel and its library calls
     are timed on operands made beforehand (bf16 for 'bf16' and 'split',
     the split pass timed apart), with the kernel's copy-only form and
     the L2 rate; the slab relayout and permute().contiguous() cold and
     warm;
  7. Lambda, certification, RDMs and the device DIIS ring (no hand kernel
     on this path): (a) H2O/cc-pVDZ in fp64 on the card, phase 2's CCSD,
     Lambda with the host ring (cc.solve_lambda) against the device ring,
     and the RDM identities; (b) the fp32 CCSD and Lambda, at the
     driver's tolerances and stopped early, upcast and certified by the
     fp64 Lagrangian energy, the raw, uncertified (the fp64 energy of the
     fp32 amplitudes) and certified gaps to the fp64 energy; (c) the
     (H2O)8 shape: two Lambda cycles with the device ring (s/cycle, peak
     memory, ring bytes), one fp32 Lambda step
     against the same step in fp64, one fp64 Lagrangian energy, two
     CCSD cycles with the host ring and then the device ring (damped by
     a level shift so the iterates stay finite), and the host ring's
     work split into its copies, NumPy concatenation, update and Gram;
     (d) the CCSD geometry scanner in fp64 against a cold run;
  8. MP2 and MP-CC (no hand kernel on these paths either; mpcc_phase):
     (a) H2O/cc-pVDZ pins in fp64 on the card (phase 2's incore
     integrals): E_MP2, the masked solver's all-frozen (E_MP2) and
     nothing-frozen (E_CCSD) limits in both bath modes, MPCCSD(4,2)
     between them on both DIIS rings, the low-level energy on
     exact-Cholesky factors; the same solves in fp32 within 1e-6 Ha, with
     the frozen blocks bit for bit the bath's; (b) (H2O)4/cc-pVDZ (host
     RHF): the fragmented workflow, one fragment per water chained, in
     fp64 (the first water's and all four's share of the MP2 -> CCSD
     gap) and fp32, the
     one-fragment no-freeze control against CCSD(mf), DF-MP2 energies and
     unrelaxed and relaxed densities (with and without a frozen core)
     against the same calls on the CPU, and the MPCC(mf) facade in fp32
     and fp64; (c) the (H2O)8 shape in fp32 on phase 1's synthetic
     integrals: masked MP-CC cycles on the device ring (damped by a
     level shift; the host ring's left out for phase 16's budget),
     low-level cycles, DF-MP2 and iterative MP2 cycles on each ring,
     with times and peak memory;
  9. the open-shell path (no hand kernel on it either; open_shell_phase):
     (a) O2 triplet/sto-3g through UHF and ROHF and H2O/sto-3g through
     UHF in fp64 on the card: E(SCF), E(UCCSD) and E(T) against pins
     made by the JAX package, the unrestricted Lambda on the host ring
     against the device ring, the make_rdm12_u energy identity, and the
     closed shell against the restricted path; (b) OH(H2O)3/cc-pVDZ
     through UHF(mol).density_fit().run() -> CCSD(mf) -> run, the
     unrestricted Lambda (device ring) and (T) in fp32, the fp32 energy
     certified by the fp64 lagrangian_energy_u against the fp64 card
     solve and the JAX package's certified campaign energy, and DF-UMP2
     energy and relaxed density on the card against the CPU; (c) the
     OH(H2O)3/cc-pVTZ shape (20, 19, 198, 199, 526) on synthetic UERIs in
     fp32: sweep time and peak, fp32 against fp64, seinsum's host share
     of a sweep (torch.profiler), CCSD cycles on each ring, Lambda
     cycles, one fp64 Lagrangian, a 64-tile UCCSD(T) probe and
     ump2.df_kernel;
 10. the open-shell MP-CC layer (no hand kernel on it either; umpcc_phase):
     (a) O2 triplet/sto-3g and H2O/6-31g UHF in fp64 on the card against
     pins made by the JAX package: the UMPCC limits (all frozen = UMP2,
     nothing frozen = UCCSD), the MPCCSD(4,2) freeze, one OO-MP2 bath
     relaxation per variant, the masked Lambda, kernel_pert_df (ccsdt-3)
     and ccsdt_env.kernel (ccsdt-1, ccsdt-3); the same solves in fp32
     within 1e-6 Ha with fp32 results and the frozen blocks bit for bit
     the bath's; (b) OH(H2O)3/cc-pVDZ in fp32: kernel_pert_df at 10+10
     active on phase 9(b)'s DF-UHF and the fragmented chain (the OH
     fragment, then the three waters; its no-freeze control is left out
     for phase 16's budget) on an exact UHF, with the global UMP2 and
     UCCSD, against the JAX package's TPU records (1e-5 Ha; the T3
     coupling 2e-6), the host parts timed apart; (c)
     the OH(H2O)3/cc-pVTZ shape in fp32: masked UMPCC cycles on each
     ring, an OO-MP2 sweep per
     variant, a kernel_pert_df cycle at 10+10 active split into its parts
     with seinsum's host share, and one environment T3 sweep at 2+2
     active on ENV_SHAPE, each with its peak memory.
 11. the (T)-response and spin-orbital layer (spinorb_phase): (a) fp64 on
     the card: QCISD(T) of H2O/cc-pVDZ (the vfac=2 path) through the
     combine kernel at chunk 1 and 4 and the resident kernel against
     engine='xla' (relative 1e-10), in total and tile by tile, the CH4
     QCISD pin, BCCD(T) of H2O/sto-3g (t1 = 0) through both kernels
     against engine='xla' (1e-10), the restricted, UHF (uccsd_t_rdm_oh) and GHF
     (gccsd_t_rdm_oh) (T) pins, Lambda(T) and the (T)-response RDM
     identities in R, U and G, the GMP2 and DF-GMP2 (h2o_dfgmp2) pins,
     kernel_pert_triples' three limits and the device DF J/K against the
     host one; (b) the same solves in fp32 within 1e-6 Ha (the resident
     kernel through engine='auto' at dot_precision='high'); (c)
     (H2O)2/cc-pVTZ frozen core in fp32: the spinor-block build, QCISD
     through QCISD(mf).run() (sweeps, s/sweep, peaks), .ccsd_t() through
     the combine kernel and its first 16 tiles through both kernels
     against engine='xla', BCCD(T) all-electron (tile 8) likewise, the
     restricted Lambda(T) cycles and make_rdm12 (s, peak, the trace and
     Euler identities), DF-GMP2.
 12. EOM-CCSD, MOM-GF-CCSD and the host-streamed Lvv (eom_stream_phase;
     no hand kernel on these paths): (a) fp64 on the card: the
     H2O/cc-pVDZ IP, EA and EE pins through the driver methods (and the
     methods at their defaults), H2/6-31g EE against the exact singlet
     spectrum, OH/sto-3g U IP/EA per spin against the host eom_slow
     oracle, eomsf_ccsd and the restricted triplet against the U EE root
     of H2O/sto-3g, MOM-GF poles against Davidson IP/EA and its moment
     conservation; (b) the H2O/cc-pVDZ roots in fp32 against fp64; (c)
     benzene/cc-pVDZ (nocc 21, nvir 93) through examples/eom_benzene in
     fp32: EE (the 4 pinned roots; the EE Davidson keeps its subspace on
     the card, lib/device_davidson), IP (3), EA (3) against the
     reference's pins, with
     Davidson cycles, sigmas, s per sigma, the Davidson's share and
     peaks, the host RHF and ERI apart; (d) one EE sigma at the (H2O)8
     shape (s, in sweeps, and peak at the EOM planner's ntile); (e) the
     streamed ladder there at ntile 8 (a seeded t1 of 1e-2): one sweep
     and one Lambda step against resident (gaps, s, peaks: the streamed peak must sit below
     the resident one by Lvv less three tiles), the bytes moved host ->
     device a sweep, the rate on the same pinned buffer and the copy time
     the compute does not hide.

 13. the multi-device layer (parallel/, the mesh (T); mesh_bench and
     shared_card): (a) a NCCL group over every visible card (rank 0 in
     this process, the others spawned) at the (H2O)8 shape in fp32 on
     synthetic integrals: with a seeded t1, one sharded_update_amps sweep
     and one update_amps_tiled sweep against rccsd.update_amps (relative
     t2 gap, s, peak); on phase 4's amplitudes, the 64-tile (T) probe
     through the mesh on the fused engine at chunk 1 and 4 and the
     resident engine in mode split against the same probe without a mesh
     (launches counted, ms a tile),
     and the 64-tile UCCSD(T) probe at the OH(H2O)3/cc-pVTZ shape through
     the mesh against the one without; (b) two ranks sharing the card
     over gloo (one spawned), fp64, small shapes: the JAX package's four
     dry-run stages (sharded RCCSD update, the sharded (T) through the
     combine and resident kernels, sharded UCCSD update, tiled update)
     and a mesh (T) whose 35 tiles the two ranks split unevenly, each
     against the same call on one rank, 1e-12.
 14. the (T) bf16 tiers on the fused engine (bf16_tier_phase;
     dot_precision 'high' and 'default': each W1 dot one bf16 GEMM with
     fp32 output, torch.mm(..., out_dtype=torch.float32), whose presence
     is checked first, feeding the combine kernel): (a) at the bench
     shape (phase 1's synthetic integrals, seed 0) the 64-tile probe,
     fused 'high' and 'default' against the resident engine in modes
     split (through engine='auto') and bf16 (rtol 1e-5) and 'high'
     against fused full precision (5e-4), three timed runs each, fused
     'high' at chunk 4, and one tile's six W1 GEMMs per tier with their
     operand split; (b) at the (H2O)12/cc-pVTZ frozen-core shape (48,
     636, 1824), past the resident kernel's shared-memory cap, the
     16-tile probe fused full, 'high' (through engine='auto', which
     must take the fused engine there) and 'default', and 2 tiles of
     each tier against engine='xla' (1e-5).
 15. the certified (H2O)8/cc-pVTZ campaign (w8_certify_phase; no hand
     kernel on this path) through examples/w8_parity_certify.run at full
     width (nocc 32, nvir 424, naux 1112, frozen core, cc-pVTZ-JKFIT): the
     host DF build, the DF-RHF with J/K in fp64 on the card (one J/K call
     on the host beside it), fp32 CCSD (conv_tol 1e-6, conv_tol_normt
     1.5e-4) and Lambda (|dl| < 1e-4) on the device DIIS rings, the
     amplitude checkpoint, and one fp64 Lagrangian energy on the card;
     E_SCF within 1e-8 Ha and the certified E_corr within 1e-7 Ha of the
     JAX package's record (docs/PARITY.md: -608.4722402812,
     -2.1875497066), each stage's seconds and peak, the raw fp32 gap
     (not gated).  The checkpoint stays for phase 16 and is removed
     after it.  (Its --reuse-scf rerun, about 10 s, is cut for phase
     17's budget; it runs on the CPU in tests/test_torch_w8_certify.py.
     Phase 17 drives benzene's SCF reuse and its certification from the
     checkpoint files on the card, bit for bit.)
 16. the full (H2O)8/cc-pVTZ (T) and the CCSD(T) pipeline
     (w8_triples_phase): (a) examples/w8_triples.run from phase 15's
     checkpoint, all 26,235 tiles twice, through engine='auto' at full
     precision (the combine kernel) and at dot-high (the resident kernel
     in mode split): launches and tiles counted, dot-high within 1e-6 of
     full precision, each within 1e-5 of the JAX package's TPU record
     (docs/PARITY.md: -0.0713274378, -0.0713276280), seconds, ms a tile
     beside the 64-tile probes', peak beside the planner's model; (b)
     every 82nd tile (320; every 41st before phase 17, cut for its
     budget) through the fused engine's prep and the
     combine kernel in fp32 against engine='xla' in fp64 on fp64
     integrals, the sum within 1e-6 and each tile within 1e-5; (c)
     examples/w8_ccsd_pipeline --small through the facade (gto -> DF-RHF
     -> CCSD(mf, frozen=2) -> .ccsd_t()) in fp32 against fp64, E_corr +
     E(T) within 1e-6 Ha.
 17. the benzene/cc-pVTZ campaign (benzene_phase), the reference
     program's headline, through examples/benzene.run at full width
     (all-electron, nocc 21, nvir 243, naux 360 with weigend fitting,
     nao 264): the DF-RHF with J/K in fp64 on the card, fp32 DF-MP2,
     CCSD (conv_tol 1e-8, conv_tol_normt 1e-6) on the device ring, the
     full (T), 5,456 tiles of edge 8 through engine='auto' (the combine
     kernel), Lambda (|dl| < 3e-6), the checkpoint and the fp64
     certification; E_SCF within 1e-8 Ha of the JAX package's fp64 pin,
     MP2 in fp32 within 1e-6 of fp64 on the same MOs, the certified E_L
     within 1e-7 of the JAX record (docs/PARITY.md: -1.065664516);
     benzene.run again on its own SCF file (the SCF reused; E_SCF, MP2
     and CCSD bit for bit), the certification again from the checkpoint
     files (--stage64) bit for bit, and every 11th tile (496) in fp32 against engine='xla' in
     fp64 (sum 1e-6, each tile 1e-5); seconds and peak by stage, cycles,
     ms a tile, beside the reference's 477.0 s on 16 Xeon cores.

Every phase raises on failure.  The last lines are the kernel record
(each kernel's launches on the full-width probe, phase 11's fp32 ones
outside its comparisons with engine='xla', phase 13(a)'s mesh probes,
phase 14's timed fused probes, phase 16's full runs and fp32
pipeline, and phase 17's full (T), its error against the
plain version, its time, the plain version's time and the least time the
card could take, from the peak rates below), the card's name and power
limit, and {"ok": true, "device": {...}}.
Without a CUDA device, or without the repository beside it, the script
exits non-zero and prints no result.
"""

import contextlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# pinned reference values (the JAX package's tests/test_rccsd.py and
# tests/test_ccsd_t.py, from the reference's own pins)
E_CCSD_SYM = -0.2133432312951
E_T_TILT = -0.0033300722704016289
# (H2O)8/cc-pVTZ frozen core, the JAX package's production shape
NOCC, NVIR, NAUX, TILE = 32, 424, 1216, 8
NPROBE = 64
# fp64 kernel vs plain: identical inputs, only the summation order differs
RTOL_FP64 = 1e-10
# fp32 tile at the (H2O)8 shape: both sides round W, V and Z in fp32
# (unit roundoff 6e-8) along different summation orders; the tile energy
# is a sum of mostly same-signed terms, so its relative error stays near
# 1e-6; 1e-5 leaves a 10x margin
RTOL_TILE_FP32 = 1e-5
# fp32 vs fp64 CCSD sweep: relative t2 difference; true fp32 GEMMs give
# ~1e-6, a TF32 matmul ~1e-3, so 1e-4 separates the two
RTOL_SWEEP_FP32 = 1e-4
# fp32 vs fp64 main path (the issue's acceptance bound)
ATOL_MAIN_FP32 = 1e-6
# the certified fp32 energy against fp64.  The repo's gate is 1e-7
# (docs/PARITY.md:3-4), but at the driver's tolerances the raw fp32 gap
# of H2O is about 1e-7 (the fp32 evaluation) and the fp64 energy of the
# fp32 amplitudes, uncertified, is already within about 5e-10: the
# certified gap must be under 1e-9 (6e-11; these three readings on an
# NVIDIA H100 80GB HBM3 at 700 W).  Stopped early
# (|dt| < 1e-3) the uncertified energy is off by O(dt), about 2e-6, the
# certified one by O(dt^2), about 4e-9 (CPU fp32): a Lagrangian that lost
# its <l, R> term would read the uncertified gap, so there the certified
# gap must be CERT_GAIN times smaller
ATOL_CERTIFIED, CERT_GAIN = 1e-9, 30
CERT_EARLY = dict(conv_tol=3e-5, conv_tol_normt=1e-3)
# Lambda on the card: host ring against device ring (max |dl|), the RDM
# identities and the scanner's warm start against a cold run
# (tests/test_lambda_rdm.py, tests/test_scanner.py)
ATOL_LAMBDA, ATOL_RDM, ATOL_SCAN = 1e-8, 1e-9, 1e-8
# resident 'split' (bf16x3) vs 'f32' probe energy: the JAX package's own
# wiring bound for the mode (tests/test_triples_fused.py:145)
RTOL_SPLIT = 5e-4
# probe dots kernel vs plain, random inputs of both signs: both sum the
# same fp32 (or exact bf16) products over K = 424 in different orders;
# the atol is this times the largest plain value (cancellation)
RTOL_DOTS = 1e-5
# MP2 and MP-CC pins, H2O/cc-pVDZ (the JAX package's tests/test_mpcc.py:14
# and tests/test_lowlevel.py:10; E_LL on exact-Cholesky factors)
E_MP2_SYM = -0.2040199672883385
E_LL_SYM = -0.20549941032564464
# MP-CC at the (H2O)8 shape: MPCCSD(4,2) on 8 of the 32 holes and 106 of
# the 424 particles (a quarter of each)
ACT_HOLES, ACT_PARTICLES = 8, 106
# fp32 against fp64 MP2 / MP-CC energies (the issue's bound, as phase 3)
# and the fp32 solves' tolerances, a few fp32 roundings of E_corr
TOL_FP32 = dict(conv_tol=1e-7, conv_tol_normt=1e-5, max_cycle=100)
# open-shell pins in fp64: (E_SCF, E_corr(UCCSD), E(T) at tile 2), sto-3g,
# SCF conv_tol 1e-12 / conv_tol_grad 1e-9, UCCSD 1e-11 / 1e-9, computed
# once by the JAX package on the CPU:
#   python - <<'PY'
#   import jax; jax.config.update("jax_platforms", "cpu")
#   jax.config.update("jax_enable_x64", True)
#   from pyscf_mpcc_tpu import gto, scf
#   from pyscf_mpcc_tpu.cc.driver import CCSD
#   for atom, spin, cls in OS_PIN_CASES:       # the three cases below
#       mf = getattr(scf, cls)(gto.M(atom=atom, basis="sto-3g", spin=spin))
#       mf.conv_tol, mf.conv_tol_grad = 1e-12, 1e-9
#       mf.kernel()
#       cc = CCSD(mf); cc.conv_tol, cc.conv_tol_normt = 1e-11, 1e-9
#       cc.kernel()
#       print(cls, spin, repr(mf.e_tot), repr(cc.e_corr),
#             repr(cc.ccsd_t(tile=2)))
#   PY
O2_ATOM = "O 0 0 0; O 0 0 1.21"
H2O_ATOM = "O 0 0 0; H 0 -0.757 0.587; H 0 0.757 0.587"
OS_PIN_CASES = (
    ("o2_uhf", O2_ATOM, 2, "UHF",
     (-147.63404850505404, -0.10860561883268052, -0.000692304464899954)),
    ("o2_rohf", O2_ATOM, 2, "ROHF",
     (-147.6322746613174, -0.11036180382544002, -0.0007192839556885072)),
    ("h2o_uhf", H2O_ATOM, 0, "UHF",
     (-74.96306312972936, -0.04946749578176114, -6.73377348713469e-05)))
# OH(H2O)3/cc-pVDZ, all electrons, default aux basis: the certified fp64
# Lagrangian total energy of the JAX package's campaign
# (docs/PARITY.md:142, examples/openshell_certify.py)
E_OH3_DZ_CERT = -304.2937049109
# certified fp32 against the fp64 card solve (docs/PARITY.md:3-4) and
# the certified total against the campaign's.  Converged, the fp32
# energy uncertified is already inside 1e-7 (3e-8, an NVIDIA H100 80GB
# HBM3 at 700 W), so as in phase 7 a solve stopped early (CERT_EARLY)
# must have its certified gap CERT_GAIN times below its uncertified one
ATOL_OS_CERT, ATOL_OS_CAMPAIGN = 1e-7, 1e-6
# OH(H2O)3/cc-pVTZ shape (nocca, noccb, nvira, nvirb, naux): nao 218,
# nelec (20, 19), cc-pvtz-jkfit; spin-orbital virtuals 397 pad to 400,
# 50 tile rows of edge 8, 22,100 (T) tiles
OS_SHAPE = (20, 19, 198, 199, 526)
OS_NTRIPS = 50 * 51 * 52 // 6
# open-shell MP-CC pins in fp64: O2 triplet/sto-3g and H2O/6-31g UHF (SCF
# conv_tol 1e-12 / conv_tol_grad 1e-9), solves to 1e-11 / 1e-9, on the
# active spaces below: the UMPCC limits (all frozen = the UMP2 guess,
# nothing frozen = OS_PIN_CASES' UCCSD), the MPCCSD(4,2) freeze, one OO-MP2
# relaxation per variant from it (the fragment's all-active blocks
# frozen), the norm of the masked Lambda (conv_tol 1e-10), kernel_pert_df
# (ccsdt-3, exact-Cholesky factors) and the environment T3 energy at its
# amplitudes (conv_tol 1e-8).  Computed once by the JAX package on the CPU
# (its ccsdt_act calls through jax.jit, the same functions, as
# tests/test_torch_ccsdt.py does):
#   python - <<'PY'
#   import sys; sys.path[:0] = [".", "tests"]
#   import jax; jax.config.update("jax_platforms", "cpu")
#   jax.config.update("jax_enable_x64", True)
#   import numpy as np, pytest
#   from pyscf_mpcc_tpu import gto, scf
#   from pyscf_mpcc_tpu.cc import uccsd, ccsdt_env
#   from pyscf_mpcc_tpu.mpcc import umpccsd
#   from test_torch_ccsdt import _jitted
#   def uhf(atom, basis, spin):
#       mf = scf.UHF(gto.M(atom=atom, basis=basis, spin=spin))
#       mf.conv_tol, mf.conv_tol_grad = 1e-12, 1e-9
#       mf.kernel()
#       return mf
#   tight = dict(conv_tol=1e-11, conv_tol_normt=1e-9, max_cycle=100)
#   er = uccsd.eris_from_scf(uhf(O2_ATOM, "sto-3g", 2))
#   print(umpccsd.kernel(er, ([0], [0]), ([0], [0]), list(range(4)),
#                        list(range(16)), **tight)[1])
#   _, e, t1, t2 = umpccsd.kernel(er, *O2_SPACE, [], list(range(15)),
#                                 **tight)
#   for v in ("standard", "t2_fock", "t2_all", "t2act"):
#       print(v, umpccsd.kernel(er, *O2_SPACE, [3], [15], t1=t1, t2=t2,
#                               oo_mp2=True, oomp2_variant=v, **tight)[1])
#   _, l1, l2 = umpccsd.lambda_kernel(er, t1, t2, *O2_SPACE, [],
#                                     list(range(15)), conv_tol=1e-10,
#                                     max_cycle=100)
#   print(np.sqrt(sum(np.sum(np.asarray(x) ** 2) for x in (*l1, *l2))))
#   mf = uhf(H2O_ATOM, "6-31g", 0)
#   eri = gto.intor_eri(mf.mol); n = eri.shape[0]
#   w, v = np.linalg.eigh(eri.reshape(n * n, n * n))
#   b = (v[:, w > 1e-12] * np.sqrt(w[w > 1e-12])).T.reshape(-1, n, n)
#   B = tuple(np.einsum("Lmn,mp,nq->Lpq", b, c, c) for c in mf.mo_coeff)
#   h = tuple(c.T @ mf.get_hcore() @ c for c in mf.mo_coeff)
#   with pytest.MonkeyPatch.context() as m:
#       _jitted(m)
#       _, e, t1, t2, _ = umpccsd.kernel_pert_df(
#           uccsd.eris_from_scf(mf), B, h, *H2O_SPACE, [], list(range(15)),
#           model="ccsdt-3", **tight)
#       print(e)
#       for model in ("ccsdt-1", "ccsdt-3"):
#           print(model, ccsdt_env.kernel(B, h, t1, t2, mf.mol.nelec,
#                                         *H2O_SPACE, tuple(mf.mo_energy),
#                                         model=model)[0])
#   PY
O2_SPACE = (([7, 8], [5, 6]), ([0], [0, 1]))
H2O_SPACE = (([2, 3, 4], [2, 3, 4]), ([0, 1, 3], [0, 1, 3]))
UMPCC_PINS = {
    "ump2": -0.09706445395696758, "partial": -0.10573775034080224,
    "standard": -0.10575318208216082, "t2_fock": -0.10067633177975123,
    "t2_all": -0.08673177501929179, "t2act": -0.09503179586041055,
    "lambda_norm": 0.2813147174900613, "pert_df": -0.12953522471971546,
    "env_ccsdt-1": -0.0007871523250640659,
    "env_ccsdt-3": -0.000911681445975489}
# OH(H2O)3/cc-pVDZ records of the JAX package's TPU v5e runs in fp32 at
# conv_tol 1e-6: UMPCC coupled to the active T3, 10+10 active a spin
# (docs/PARITY.md:397-399, examples/umpcc_t3_chip.py), and the fragmented
# chain (docs/PARITY.md:431-437, examples/mpcc_fragmented_chip.py).  Each
# port energy within ATOL_REC of its record, the coupling within
# ATOL_COUPLING.  Of the fragmented runs the chain runs (it starts from
# the OH fragment, the radical's solve): its no-freeze control took 34-48
# s of the script's budget, which phase 16 needs; phase 10(a) holds the
# nothing-frozen limit on the pins' molecules
REC_OH3 = {"uccsd": -0.8142849207, "uccsd_t3": -0.8143755198,
           "coupling": -0.8143755198 + 0.8142849207,
           "frag_mp2": -0.7737513781, "frag_radical": -0.7857607007,
           "frag_chain": -0.8114969134, "frag_control": -0.8138623238,
           "frag_uccsd": -0.8138632774}
ATOL_REC, ATOL_COUPLING = 1e-5, 2e-6
OH3_N_ACT = 10
# the environment T3 sweep of phase 10(c): OS_SHAPE with the virtual
# ranges cut to 24/25 (its t3 is o^3 v^3 a block, 6.2e10 elements in
# fp32 at nvir 198, 1.1e8 here)
ENV_SHAPE = (20, 19, 24, 25, 526)
# phase 11 pins, from the JAX package's tests and docs/reference_pins.json:
# CH4/cc-pVDZ frozen-core QCISD total (tests/test_qcisd.py:9, the
# reference's test_qcisd.py), the (T) energies of uccsd_t_rdm_oh (OH/6-31g
# UHF) and gccsd_t_rdm_oh (OH/sto-3g GHF), and h2o_dfgmp2
# (tests/test_dfgmp2.py:20-23)
CH4_ATOM = """C  0.000  0.000  0.000
              H  0.637  0.637  0.637
              H -0.637 -0.637  0.637
              H -0.637  0.637 -0.637
              H  0.637 -0.637 -0.637"""
E_TOT_CH4_QCISD = -40.3839884
ET_UCCSD_T_RDM_OH = -0.0005574953727482226
ET_GCCSD_T_RDM_OH = -2.3003877157816884e-07
DFGMP2_ATOM = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
E_DFGMP2 = {"sto-3g": -0.035490285389463326, "631g": -0.12877271226149506}
# (H2O)2/cc-pVTZ: the first two waters of the (H2O)8 cube of
# examples/w8_ccsd_pipeline.py (testing.W4_GEOM[:6]); nao 116, two O 1s
# frozen: restricted (nocc, nvir) (8, 106), spinor (16, 212)
W2_BASIS, NPROBE_SO = "cc-pvtz", 16
# phase 12: H2O/cc-pVDZ at the geometry of the JAX package's
# tests/test_eom_ip_ea.py and its pins (docs/reference_pins.json
# h2o_ccpvdz: the reference's eom_rccsd on integrals injected from the
# JAX package), its limits there (IP/EA 1e-7, EE 5e-7 Ha)
EOM_H2O = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
EOM_PINS = {"e_corr": -0.2133274273544366,
            "ip": [0.433564372260947, 0.5186599930972678,
                   0.6784704515875678],
            "ea": [0.16741950216613447, 0.24029462761583625,
                   0.5101075032617646],
            "ee": [0.3006258759956825, 0.37594403988325975,
                   0.397748269999603]}
# the driver methods at their default Davidson tolerances (residual norm
# 1e-7 IP/EA, 1e-6 EE) against the tight roots
ATOL_EOM_DEFAULTS = 1e-5
# fp32 EOM: CCSD and Davidson at the JAX benzene example's tolerances; the
# fp32 sigma rounds at ~1e-7 of |A| (a few Ha) and the amplitudes are good
# to ~3e-6, so the roots sit ~1e-6 from fp64: 2e-5 Ha leaves a margin
EOM_FP32_CCSD = dict(conv_tol=1e-8, conv_tol_normt=3e-6, max_cycle=100)
EOM_FP32_TOL, ATOL_EOM_FP32 = 1e-5, 2e-5
# benzene/cc-pVDZ in fp32 against benzene_ccpvdz: twice the pass bar of
# the JAX package's examples/eom_benzene_chip.py (1e-3 eV)
ATOL_BENZENE_EV = 2e-3
# the EE sector's lowest roots: all four pinned (at one root the Davidson
# lands on the second state, 6.868 eV; the host Davidson took 207.9-219.3
# s at four, so two ran until lib/device_davidson took the EE subspace)
BENZENE_EE_ROOTS = 4
# the streamed ladder at the (H2O)8 shape: row tiles a virtual axis, and
# streamed against resident in fp32 (the same products in other GEMM
# blockings; relative norm of t2 and of the Lambda residual)
NTILE_STREAM, RTOL_STREAM = 8, 1e-5
# published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W):
# bytes/s of HBM3 and FLOP/s per operand type, for the kernels' bounds
PEAK = {"bytes": 3.35e12, "fp32": 67e12, "fp64": 67e12, "bf16": 989e12}
# phase 13: the mesh against the same call on one rank.  fp64 on one
# card: the same products, partial sums added in another order (the CPU
# tests' bound for the updates and the (T)); the tiled update 1e-11 there
ATOL_MESH_FP64 = 1e-12
# the spawned ranks' time limit (s): start-up, the build check, the work
RANK_TIMEOUT = 300
# phase 14(b): (H2O)12/cc-pVTZ frozen core (nocc 48, nvir 636, naux 1824;
# twelve waters, 12 x 58 = 696 basis functions, 12 O 1s frozen), past the
# resident kernel's shared-memory cap (fp32 nocc 36)
NOCC12, NVIR12, NAUX12, NPROBE12 = 48, 636, 1824, 16
# phase 15: the certified (H2O)8/cc-pVTZ campaign against the JAX
# package's record (docs/PARITY.md:21, :63): the DF-RHF energy to 1e-8 Ha
# and the certified E_corr to the BASELINE gate, 1e-7 Ha, at the record's
# shape (frozen core, cc-pVTZ-JKFIT)
ATOL_W8_SCF, ATOL_W8_CERTIFIED = 1e-8, 1e-7
W8_SHAPE = (32, 424, 1112)
# the same bf16 tier on two engines: the same exact bf16 products summed
# in fp32 in other orders, as RTOL_TILE_FP32
RTOL_TIER = 1e-5
# phase 16: the full (T) from phase 15's checkpoint, every tile of edge
# 8 (nvir 424: 53 tile rows), against the JAX package's TPU records
# (docs/PARITY.md:113 'highest', :23 dot-high).  Those ran on the TPU's own
# fp32 fixed point (e32 -2.1875844002), 3.77e-5 from the card's, and E(T)
# moves to first order with the amplitudes (about 2 E(T) |dt|/|t|, 1e-6
# to 3e-6), hence 1e-5; the tight checks are the card's own: dot-high
# against full precision within 1e-6 (the TPU's 1.8e-7,
# docs/PARITY.md:113-114), and every 82nd tile (320) in fp32 against
# fp64 (the sum within 1e-6, each tile within RTOL_TILE_FP32); every
# 41st before phase 17, cut for its budget
W8_TILE, W8_NTILES = 8, 26235
W8_ET_TPU = {"highest": -0.0713274378, "dot-high": -0.0713276280}
ATOL_W8_ET_RECORD, ATOL_W8_ET_TIER = 1e-5, 1e-6
W8_SAMPLE_STRIDE, RTOL_W8_SAMPLE = 82, 1e-6
# phase 17: benzene/cc-pVTZ all-electron, weigend fitting (nao 264), the
# JAX script's settings; its pins and record are examples/benzene.PINS and
# RECORD.  E_SCF to 1e-8 Ha as phase 15; MP2 in fp32 against fp64 on the
# same MOs to ATOL_MAIN_FP32; the certified E_corr to the BASELINE gate,
# 1e-7 Ha (the record carries 9 decimals); nvir 243 pads to 248 at tile
# 8 (31 tile rows, the last ragged); every 11th tile (496) in fp32
# against fp64 as phase 16(b)
BZ_SHAPE, BZ_NAO = (21, 243, 360), 264
ATOL_BZ_SCF, ATOL_BZ_CERTIFIED = 1e-8, 1e-7
BZ_TILE, BZ_NTILES, BZ_SAMPLE_STRIDE = 8, 5456, 11


def say(phase, msg, **kw):
    extra = " ".join(f"{k}={v}" for k, v in kw.items())
    print(f"[phase {phase}] {msg} {extra}".rstrip(), flush=True)


def nvidia_smi(query):
    """First line of nvidia-smi's csv answer to --query-gpu=query."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


# sampled beside the timed phases: a card below its clocks or power runs
# slower, and the timings are read against these
CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def cuda_ms(torch, fn, n):
    """Mean device milliseconds of fn over n launches (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def trace_top(torch, fn, n, k=6):
    """Device time per call of the k costliest kernels of fn, from a
    torch.profiler trace over n calls: [(name, ms per call, calls)]."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            rows.append((ev.key[:48], round(us / n / 1e3, 4),
                         ev.count // n))
    return sorted(rows, key=lambda r: -r[1])[:k]


def nbytes(*xs):
    """Bytes of the tensors in xs (nested lists allowed; None skipped)."""
    tot = 0
    for x in xs:
        if isinstance(x, (list, tuple)):
            tot += nbytes(*x)
        elif x is not None:
            tot += x.numel() * x.element_size()
    return tot


def seconds(torch, fn):
    """(fn(), host seconds), the card synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound_ms(nbyte, flops):
    """Least milliseconds for nbyte of traffic and flops {type: count}:
    the larger of the byte time and the summed operation times."""
    t_b = nbyte / PEAK["bytes"]
    t_o = sum(n / PEAK[k] for k, n in flops.items())
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def mpcc_phase(torch, smi, cc, beris, bt1, bt2, sweep_sec, ntile):
    """Phase 8: MP2 and MP-CC on the card.  cc: phase 2's fp64 H2O/cc-pVDZ
    driver (incore integrals on the card); beris, bt1, bt2: phase 1's fp32
    synthetic integrals and MP2 amplitudes at the (H2O)8 shape;
    sweep_sec, ntile: phase 4's sweep time and ladder tiling."""
    import numpy as np
    from pyscf_mpcc_tpu_torch import gto, testing
    from pyscf_mpcc_tpu_torch.cc import rccsd
    from pyscf_mpcc_tpu_torch.cc.driver import CCSD
    from pyscf_mpcc_tpu_torch.cc.eris import RERIs, df_factors
    from pyscf_mpcc_tpu_torch.mp import DFRMP2, mp2
    from pyscf_mpcc_tpu_torch.mpcc import MPCC, lowlevel, rmpccsd, workflow
    from pyscf_mpcc_tpu_torch.mpcc.masks import frozen_masks
    from pyscf_mpcc_tpu_torch.scf import RHF

    f64, f32 = torch.float64, torch.float32
    dev, cpu = beris.ovov.device, torch.device("cpu")

    def frozen(space, n_occ, n_vir):
        """The space's frozen-block masks as bool tensors on the card."""
        return [torch.as_tensor(m, device=dev) for m in frozen_masks(
            space["act_hole"], space["act_particle"], n_occ, n_vir,
            space["idx_s"], space["idx_d"])]

    # (a) H2O/cc-pVDZ: the pins in fp64, the same solves in fp32
    t0 = time.perf_counter()
    nocc, mo = cc.nocc, cc.mo_coeff
    eri = cc._eri_ao if cc._eri_ao is not None else gto.intor_eri(cc.mol)
    nao = eri.shape[0]
    w, v = np.linalg.eigh(eri.reshape(nao * nao, nao * nao))
    keep = w > 1e-12
    b_chol = (v[:, keep] * np.sqrt(w[keep])).T.reshape(-1, nao, nao)
    fock_mo = mo.T @ cc._scf.get_fock(cc._scf.make_rdm1()) @ mo
    spaces = {
        "all_frozen": dict(act_hole=[0, 1], act_particle=[0, 1],
                           idx_s=list(range(4)), idx_d=list(range(16))),
        "no_freeze": dict(act_hole=[0, 1], act_particle=[0, 1], idx_s=[],
                          idx_d=[]),
        "mpccsd42": dict(act_hole=[2, 3, 4], act_particle=[0, 1, 2, 3],
                         idx_s=[], idx_d=list(range(15)))}
    tol = {f64: dict(conv_tol=1e-10, conv_tol_normt=1e-8, max_cycle=100),
           f32: TOL_FP32}
    got, bit_exact = {}, True
    for dt in (f64, f32):
        er = cc.eris if dt == f64 else RERIs(*(None if x is None else
                                               x.float() for x in cc.eris))
        r = {"mp2": float(mp2.kernel(er.mo_energy[:nocc],
                                     er.mo_energy[nocc:], er.ovov)[0])}
        for bath in ("freeze", "mp2"):
            for name in ("all_frozen", "no_freeze"):
                conv, r[f"{name}_{bath}"], *_ = rmpccsd.kernel(
                    er, **spaces[name], bath_update=bath, **tol[dt])
                if not conv:
                    raise RuntimeError(f"{name} ({bath}, {dt}) unconverged")
        _, t1_0, t2_0 = rccsd.init_amps(er)
        m1, m2 = frozen(spaces["mpccsd42"], nocc, er.nvir)
        for ring in ("host", "device"):
            conv, r[f"mpccsd42_{ring}"], t1, t2 = rmpccsd.kernel(
                er, **spaces["mpccsd42"], t1=t1_0, t2=t2_0,
                diis_backend=ring, **tol[dt])
            bit_exact &= bool(torch.equal(t1[m1], t1_0[m1])
                              and torch.equal(t2[m2], t2_0[m2]))
            if not conv:
                raise RuntimeError(f"MPCCSD(4,2) ({ring}, {dt}) unconverged")
        conv, r["lowlevel"], *_ = lowlevel.kernel(
            *df_factors(b_chol, mo, nocc, dt, device=dev), fock_mo, nocc,
            conv_tol=1e-9 if dt == f64 else 1e-6)
        if not conv:
            raise RuntimeError(f"low-level solver ({dt}) unconverged")
        got[dt] = r
    r64 = got[f64]
    d32 = max(abs(got[f32][k] - r64[k]) for k in r64)
    checks = {
        "mp2": abs(r64["mp2"] - E_MP2_SYM) < 1e-9,
        "all_frozen": abs(r64["all_frozen_freeze"] - E_MP2_SYM) < 1e-9,
        "no_freeze": abs(r64["no_freeze_freeze"] - E_CCSD_SYM) < 1e-7,
        "mp2_bath": (abs(r64["all_frozen_mp2"] - E_MP2_SYM) < 1e-8
                     and abs(r64["no_freeze_mp2"] - E_CCSD_SYM) < 1e-7),
        "mpccsd42": all(E_CCSD_SYM - 1e-9 < r64[f"mpccsd42_{ring}"]
                        < E_MP2_SYM + 1e-9 for ring in ("host", "device")),
        "lowlevel": abs(r64["lowlevel"] - E_LL_SYM) < 1e-8,
        "fp32": d32 < ATOL_MAIN_FP32, "bit_exact": bit_exact}
    if not all(checks.values()):
        raise RuntimeError(f"MP-CC pins: {checks} {got}")
    say(8, "h2o mp2/mpcc pins fp64 ok",
        **{k: repr(v) for k, v in r64.items()})
    say(8, "h2o fp32 vs fp64 ok", max_abs_diff=f"{d32:.3e}",
        atol=ATOL_MAIN_FP32, frozen_blocks_bit_exact=bit_exact,
        seconds=f"{time.perf_counter() - t0:.1f}")

    # (b) (H2O)4/cc-pVDZ: the fragmented workflow, DF-MP2, the facade
    t0 = time.perf_counter()
    mol = gto.M(atom=testing.W4_GEOM, basis="cc-pvdz")
    mf = RHF(mol)
    mf.conv_tol = 1e-10
    mf.kernel()
    eri = gto.intor_eri(mol)
    ref = CCSD(mf, device=dev, dtype=f64).set(conv_tol=1e-10,
                                               conv_tol_normt=1e-8).run()
    e_mp2 = ref.emp2
    if not (mf.converged and ref.converged):
        raise RuntimeError("(H2O)4 RHF or CCSD unconverged")
    say(8, "(H2O)4 reference", nocc=ref.nocc, nmo=ref.nmo,
        e_rhf=repr(mf.e_tot), e_mp2=repr(e_mp2), e_ccsd=repr(ref.e_corr),
        seconds=f"{time.perf_counter() - t0:.1f}")
    nw = mol.natm // 3           # one fragment (and one O 1s core) a water
    waters = [[3 * i, 3 * i + 1, 3 * i + 2] for i in range(nw)]
    chain = dict(idx_s=[], idx_d=list(range(15)), eri_ao=eri)
    # the chain of the first water and of all four (the two between took
    # 26 s of the script's budget, which phase 16 needs)
    e_chain = []
    for k in (1, nw):
        e, _, _, _, sp = workflow.fragmented_mpcc(
            mol, mf, waters[:k], device=dev, dtype=f64, **chain)
        e_chain.append(e)
    gap = ref.e_corr - e_mp2
    (e32, *_), s32 = seconds(torch, lambda: workflow.fragmented_mpcc(
        mol, mf, waters, device=dev, dtype=f32, mp2_conv=1e-7,
        cc_conv=1e-7, **chain))
    (e_ctrl, *_), s_ctrl = seconds(torch, lambda: workflow.fragmented_mpcc(
        mol, mf, [list(range(mol.natm))], [], [], eri_ao=eri,
        pop_threshold=-1.0, cc_conv=1e-10, device=dev, dtype=f64))
    if not (all(ref.e_corr - 1e-7 <= e <= e_mp2 + 1e-7 for e in e_chain)
            and abs(e_ctrl - ref.e_corr) < 1e-7
            and abs(e32 - e_chain[-1]) < ATOL_MAIN_FP32):
        raise RuntimeError(f"(H2O)4 workflow: chain {e_chain}, fp32 {e32}, "
                           f"control {e_ctrl} vs CCSD {ref.e_corr}")
    say(8, "(H2O)4 fragmented mpcc ok", idx_d="0-14",
        spaces=json.dumps([[len(h), len(p)] for h, p in sp]),
        e_chain=json.dumps(e_chain),
        share_of_gap=json.dumps([round((e - e_mp2) / gap, 4)
                                 for e in e_chain]),
        e_fp32=repr(e32), d_fp32=f"{e32 - e_chain[-1]:.3e}",
        sec_fp32_chain=f"{s32:.1f}",
        d_control_ccsd=f"{e_ctrl - ref.e_corr:.2e}",
        sec_control=f"{s_ctrl:.1f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    del ref

    t0 = time.perf_counter()
    mfd = RHF(mol).density_fit()
    mfd.conv_tol = 1e-10
    mfd.kernel()
    for nfro in (0, nw):
        out = []     # (E, unrelaxed, relaxed, s energy, s relaxed): card, CPU
        for d in (dev, cpu):
            m, s_e = seconds(torch, lambda: DFRMP2(mfd, frozen=nfro, device=d,
                                            dtype=f64).run())
            dm_u = m.make_rdm1()
            # twice on the card: the first call also loads the solver
            # and autograd libraries (once on the CPU, which has none)
            s_r = [seconds(torch, lambda: m.make_rdm1(relaxed=True))
                   for _ in range(2 if d == dev else 1)]
            out.append((m.e_corr, dm_u.cpu(), s_r[-1][0].cpu(), s_e,
                        [t for _, t in s_r]))
        de = abs(out[0][0] - out[1][0])
        ddm = max(float((out[0][i] - out[1][i]).abs().max()) for i in (1, 2))
        d_tr = float(torch.trace(out[0][2])) - mol.nelectron
        if not (de < 1e-8 and ddm < 1e-8 and abs(d_tr) < 1e-8):
            raise RuntimeError(f"DF-MP2 frozen={nfro}: dE {de}, ddm {ddm}, "
                               f"trace-N {d_tr}")
        say(8, "(H2O)4 dfmp2 fp64 ok", frozen=nfro, e_corr=repr(out[0][0]),
            d_cpu=f"{de:.2e}", max_abs_ddm_cpu=f"{ddm:.2e}",
            relaxed_trace_err=f"{d_tr:.2e}", sec_energy=f"{out[0][3]:.3f}",
            sec_relaxed_first=f"{out[0][4][0]:.3f}",
            sec_relaxed=f"{out[0][4][1]:.3f}",
            sec_relaxed_cpu=f"{out[1][4][0]:.3f}")
    facade = {}
    for dt in (f32, f64):
        m = MPCC(mfd, device=dev, dtype=dt)
        e = m.kernel(act_hole=list(range(m.nocc - 8, m.nocc)),
                     act_particle=list(range(16)), idx_s=[],
                     idx_d=list(range(15)), **tol[dt])
        if not (m.converged and m.t2.dtype == dt):
            raise RuntimeError(f"MPCC facade ({dt}) unconverged")
        facade[dt] = (m.e_lowlevel, e)
    d_ll = facade[f32][0] - facade[f64][0]
    d_hl = facade[f32][1] - facade[f64][1]
    if not (abs(d_ll) < ATOL_MAIN_FP32 and abs(d_hl) < ATOL_MAIN_FP32):
        raise RuntimeError(f"MPCC facade fp32 vs fp64: {facade}")
    say(8, "(H2O)4 MPCC(mf) ok", e_lowlevel=repr(facade[f64][0]),
        e_mpccsd42=repr(facade[f64][1]), d_lowlevel_fp32=f"{d_ll:.2e}",
        d_mpccsd42_fp32=f"{d_hl:.2e}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    del mfd, m

    # (c) the (H2O)8 shape in fp32.  The synthetic integrals are not a
    # molecule's; the cycles are timed, not converged (conv_tol 0), and
    # damped by a level shift where their iterates would overflow
    no, nv = bt1.shape
    shift = 1e9
    space = dict(act_hole=list(range(no - ACT_HOLES, no)),
                 act_particle=list(range(ACT_PARTICLES)), idx_s=[],
                 idx_d=list(range(15)))
    t0 = time.perf_counter()
    m1, m2 = frozen(space, no, nv)
    t_masks = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    # a cycle's time is the difference of two calls, which share the
    # per-call set-up (the host mask build, init_amps, the ring).  The
    # device ring only: the host ring's calls cost 19 s of the script's
    # budget, and 8(a) runs the masked solver on both rings
    ncyc, secs = (1, 3), []
    for n in ncyc:
        torch.cuda.reset_peak_memory_stats()
        (_, e, c1, c2), sec_k = seconds(torch, lambda: rmpccsd.kernel(
            beris, **space, t1=bt1, t2=bt2, max_cycle=n, conv_tol=0.0,
            ntile=ntile, level_shift=shift, diis_backend="device"))
        peak = torch.cuda.max_memory_allocated()
        exact = not bool(((c2 != bt2) & m2).any()
                         or ((c1 != bt1) & m1).any())
        if not (torch.isfinite(c1).all() and torch.isfinite(c2).all()
                and abs(e) < float("inf") and exact):
            raise RuntimeError(f"masked cycles (device, {n}): E {e}, "
                               f"frozen blocks exact {exact}")
        del c1, c2
        secs.append(sec_k)
    per = (secs[1] - secs[0]) / (ncyc[1] - ncyc[0])
    row = {f"sec_call_{n}": f"{t:.3f}" for n, t in zip(ncyc, secs)}
    row.update(sec_per_cycle=f"{per:.3f}", sec_setup=f"{secs[0] - per:.3f}",
               peak_gib=f"{peak / 2**30:.2f}")
    say(8, "(H2O)8 masked mpccsd fp32", shape=f"{no},{nv}",
        active=f"{ACT_HOLES}x{ACT_PARTICLES}", level_shift=shift,
        device_ring=json.dumps(row), sec_masks_host=f"{t_masks:.3f}",
        sweep_sec_phase4=f"{sweep_sec:.4f}", base_gib=f"{base / 2**30:.2f}",
        frozen_blocks_bit_exact=True, card=json.dumps(smi),
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    del m1, m2

    fock = beris.fock.double().cpu().numpy().copy()
    fock[range(no, no + nv), range(no, no + nv)] += shift
    torch.cuda.reset_peak_memory_stats()
    (_, e_ll, l1, l2), sec_ll = seconds(torch, lambda: lowlevel.kernel(
        beris.Loo, beris.Lov, beris.Lvv, fock, no, max_cycle=3,
        conv_tol=0.0))
    peak_ll = torch.cuda.max_memory_allocated()
    if not (torch.isfinite(l1).all() and torch.isfinite(l2).all()
            and abs(e_ll) < float("inf")):
        raise RuntimeError(f"non-finite low-level cycles: E {e_ll}")
    del l1, l2
    eo, ev = beris.mo_energy[:no], beris.mo_energy[no:]
    mp2.df_kernel(eo, ev, beris.Lov)
    torch.cuda.reset_peak_memory_stats()
    (e_df, t2_df), sec_df = seconds(
        torch, lambda: mp2.df_kernel(eo, ev, beris.Lov))
    peak_df = torch.cuda.max_memory_allocated()
    if not (torch.isfinite(t2_df).all() and torch.isfinite(e_df)):
        raise RuntimeError("non-finite DF-MP2 at the (H2O)8 shape")
    del t2_df
    it = {}
    for ring in ("device", "host"):
        torch.cuda.reset_peak_memory_stats()
        (e_it, t2_it, _), sec_it = seconds(torch, lambda: mp2.iterative_kernel(
            beris.ovov, beris.fock[:no, :no], beris.fock[no:, no:],
            max_cycle=2, conv_tol=0.0, diis_backend=ring))
        if not (torch.isfinite(t2_it).all() and abs(e_it) < float("inf")):
            raise RuntimeError(f"non-finite iterative MP2 ({ring})")
        del t2_it
        peak_it = torch.cuda.max_memory_allocated()
        it[ring] = dict(sec_per_cycle=f"{sec_it / 2:.3f}",
                        peak_gib=f"{peak_it / 2**30:.2f}")
    # where the time of a low-level cycle and of DF-MP2 goes
    args = (torch.zeros_like(bt1), beris.Loo, beris.Lov, beris.Lvv,
            torch.zeros_like(beris.fock[:no, :no]),
            torch.zeros_like(beris.fock[no:, no:]),
            (ev[None, :] - eo[:, None]) + shift)
    say(8, "(H2O)8 lowlevel update trace", top=json.dumps(trace_top(
        torch, lambda: lowlevel.update_amps(*args), 2)))
    say(8, "(H2O)8 df_kernel trace", top=json.dumps(trace_top(
        torch, lambda: mp2.df_kernel(eo, ev, beris.Lov), 3)))
    del args
    say(8, "(H2O)8 lowlevel, mp2 fp32", lowlevel_cycles=3,
        lowlevel_sec_per_cycle=f"{sec_ll / 3:.4f}",
        lowlevel_peak_gib=f"{peak_ll / 2**30:.2f}",
        df_mp2_sec=f"{sec_df:.4f}", df_mp2_peak_gib=f"{peak_df / 2**30:.2f}",
        e_df_mp2=repr(float(e_df)),
        iterative_device_ring=json.dumps(it["device"]),
        iterative_host_ring=json.dumps(it["host"]), card=json.dumps(smi),
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))


def open_shell_phase(torch, smi, dev):
    """Phase 9: the open-shell path on the card (no hand kernel on it).
    (a) sto-3g pins in fp64; (b) OH(H2O)3/cc-pVDZ through the entry
    points, fp32 certified by the fp64 Lagrangian, and DF-UMP2; (c) the
    OH(H2O)3/cc-pVTZ shape on synthetic integrals in fp32."""
    from pyscf_mpcc_tpu_torch import ao2mo, gto, testing
    from pyscf_mpcc_tpu_torch import scf as pscf
    from pyscf_mpcc_tpu_torch.cc import lambda_ad, uccsd, uccsd_t
    from pyscf_mpcc_tpu_torch.cc.driver import CCSD
    from pyscf_mpcc_tpu_torch.examples import uccsd_oh
    from pyscf_mpcc_tpu_torch.mp import DFUMP2, ump2

    f64, f32 = torch.float64, torch.float32
    cpu = torch.device("cpu")
    tight = dict(conv_tol=1e-11, conv_tol_normt=1e-9)

    def maxdiff(xs, ys):
        return max(float((a - b).abs().max()) for a, b in zip(xs, ys))

    # (a) the pins in fp64 on the card
    t0 = time.perf_counter()
    e_cs = {}
    for name, atom, spin, cls, pin in OS_PIN_CASES:
        mf = getattr(pscf, cls)(gto.M(atom=atom, basis="sto-3g", spin=spin))
        mf.conv_tol, mf.conv_tol_grad = 1e-12, 1e-9
        mf.kernel()
        cc = CCSD(mf, device=dev, dtype=f64).set(**tight).run()
        et = cc.ccsd_t(tile=2)
        lam = {ring: lambda_ad.kernel_u(cc.t1, cc.t2, cc.eris,
                                        conv_tol=1e-10, max_cycle=100,
                                        diis_backend=ring)
               for ring in ("host", "device")}
        dl = maxdiff((*lam["host"][1], *lam["host"][2]),
                     (*lam["device"][1], *lam["device"][2]))
        mo = [torch.as_tensor(c, dtype=f64, device=dev) for c in mf.mo_coeff]
        eri = torch.as_tensor(gto.intor_eri(mf.mol), dtype=f64, device=dev)
        h = torch.as_tensor(mf.get_hcore(), dtype=f64, device=dev)
        ints = (mo[0].T @ h @ mo[0], mo[1].T @ h @ mo[1],
                ao2mo.full(eri, mo[0]),
                ao2mo.general(eri, (mo[0], mo[0], mo[1], mo[1])),
                ao2mo.full(eri, mo[1]))
        (d1a, d1b), (d2aa, d2ab, d2bb) = lambda_ad.make_rdm12_u(
            *ints, cc.t1, cc.t2, lam["host"][1], lam["host"][2],
            *mf.mol.nelec)
        e_rdm = float((ints[0] * d1a).sum() + (ints[1] * d1b).sum()
                      + 0.5 * (ints[2] * d2aa).sum() + (ints[3] * d2ab).sum()
                      + 0.5 * (ints[4] * d2bb).sum()) + mf.mol.energy_nuc()
        d = (mf.e_tot - pin[0], cc.e_corr - pin[1], et - pin[2],
             e_rdm - cc.e_tot)
        if not (mf.converged and cc.converged
                and all(c[0] for c in lam.values()) and abs(d[0]) < 1e-10
                and abs(d[1]) < 1e-9 and abs(d[2]) < 1e-9
                and dl < ATOL_LAMBDA and abs(d[3]) < 1e-8
                and cc.t2[1].device.type == dev.type):
            raise RuntimeError(f"{name} pins: dE(SCF, UCCSD, (T), RDM) {d}, "
                               f"Lambda rings {dl}")
        say(9, f"{name} pins fp64 ok", d_scf=f"{d[0]:.1e}",
            d_uccsd=f"{d[1]:.1e}", d_t=f"{d[2]:.1e}", lambda_rings=f"{dl:.1e}",
            rdm_identity=f"{d[3]:.1e}")
        if name == "h2o_uhf":
            e_cs = dict(uccsd=cc.e_corr, t=et)
    # the closed shell through the restricted path (phase 2's engines)
    rmf = pscf.RHF(gto.M(atom=H2O_ATOM, basis="sto-3g"))
    rmf.conv_tol, rmf.conv_tol_grad = 1e-12, 1e-9
    rmf.kernel()
    rcc = CCSD(rmf, device=dev, dtype=f64).set(**tight).run()
    d_r = (e_cs["uccsd"] - rcc.e_corr, e_cs["t"] - rcc.ccsd_t(tile=8))
    if not (abs(d_r[0]) < 1e-9 and abs(d_r[1]) < 1e-9):
        raise RuntimeError(f"closed-shell UCCSD vs RCCSD: {d_r}")
    say(9, "h2o uhf = rhf path ok", d_uccsd_rccsd=f"{d_r[0]:.1e}",
        d_t=f"{d_r[1]:.1e}", seconds=f"{time.perf_counter() - t0:.1f}")

    # (b) OH(H2O)3/cc-pVDZ through the entry points
    t0 = time.perf_counter()
    mf = uccsd_oh.uhf("cc-pvdz")
    t_scf = time.perf_counter() - t0
    if not mf.converged:
        raise RuntimeError("OH(H2O)3 UHF unconverged")
    c32, s_cc = seconds(torch, lambda: CCSD(mf, device=dev, dtype=f32).set(
        conv_tol=1e-8, conv_tol_normt=1e-6, diis_backend="device").run())
    (cl, l1, l2), s_l = seconds(torch, lambda: lambda_ad.kernel_u(
        c32.t1, c32.t2, c32.eris, conv_tol=3e-6, max_cycle=60,
        diis_backend="device"))
    e_cert, s_cert = seconds(torch, lambda: uccsd_oh.certify(c32, l1, l2))
    et32, s_t = seconds(torch, lambda: c32.ccsd_t(tile=8))
    # the fp64 reference: the energy to 1e-10; |dt| stalls near 1.2e-7
    # here, in the JAX package's solver as in the port's (both read
    # 1.24e-7 after 60 cycles with dE 6e-13 on the CPU in fp64:
    # tools/uccsd_fp64_convergence.py), so the amplitude bound is the
    # campaign's 1e-6
    c64, s_cc64 = seconds(torch, lambda: CCSD(mf, device=dev, dtype=f64).set(
        conv_tol=1e-10, conv_tol_normt=1e-6).run())
    et64 = c64.ccsd_t(tile=8)
    e_unc = float(uccsd.energy(tuple(x.double() for x in c32.t1),
                               tuple(x.double() for x in c32.t2), c64.eris))
    gaps = (c32.e_corr - c64.e_corr, e_unc - c64.e_corr,
            e_cert - c64.e_corr)
    d_camp = mf.e_tot + e_cert - E_OH3_DZ_CERT
    # converged, the fp32 energy is already inside ATOL_OS_CERT; stopped
    # early (phase 7's CERT_EARLY) the certificate must gain CERT_GAIN
    c_e = CCSD(mf, device=dev, dtype=f32).set(
        diis_backend="device", **CERT_EARLY).run()
    _, l1_e, l2_e = lambda_ad.kernel_u(c_e.t1, c_e.t2, c_e.eris,
                                       conv_tol=3e-6, max_cycle=60,
                                       diis_backend="device")
    gaps_e = (float(uccsd.energy(tuple(x.double() for x in c_e.t1),
                                 tuple(x.double() for x in c_e.t2),
                                 c64.eris)) - c64.e_corr,
              uccsd_oh.certify(c_e, l1_e, l2_e) - c64.e_corr)
    del c_e, l1_e, l2_e
    if not (c32.converged and cl and c64.converged
            and c32.t2[1].dtype == f32 and abs(gaps[2]) < ATOL_OS_CERT
            and abs(gaps_e[1]) * CERT_GAIN < abs(gaps_e[0])
            and abs(et32 - et64) < ATOL_MAIN_FP32
            and abs(d_camp) < ATOL_OS_CAMPAIGN):
        raise RuntimeError(
            f"OH(H2O)3: gaps (raw, uncertified, certified) {gaps}, "
            f"early (uncertified, certified) {gaps_e}, "
            f"E(T) fp32-fp64 {et32 - et64}, certified total - campaign "
            f"{d_camp} (E_UHF {mf.e_tot!r}), converged (fp32, Lambda, "
            f"fp64) {c32.converged} {cl} {c64.converged}")
    na, nb = mf.mol.nelec
    say(9, "OH(H2O)3/cc-pVDZ ok", nao=mf.mol.nao, nelec=f"{na},{nb}",
        naux=c32.eris.Lov_a.shape[0], e_uhf=repr(mf.e_tot),
        e_corr_fp32=repr(c32.e_corr), e_corr_fp64=repr(c64.e_corr),
        e_certified=repr(e_cert), raw_gap=f"{gaps[0]:.3e}",
        uncertified_gap=f"{gaps[1]:.3e}", certified_gap=f"{gaps[2]:.3e}",
        early_uncertified_gap=f"{gaps_e[0]:.3e}",
        early_certified_gap=f"{gaps_e[1]:.3e}", min_gain=CERT_GAIN,
        e_tot_certified=repr(mf.e_tot + e_cert),
        d_campaign=f"{d_camp:.2e}", e_t_fp32=repr(et32),
        e_t_fp64=repr(et64), d_t=f"{et32 - et64:.2e}",
        sec_uhf_host=f"{t_scf:.1f}", sec_uccsd_fp32=f"{s_cc:.2f}",
        sec_lambda_fp32=f"{s_l:.2f}", sec_certify_fp64=f"{s_cert:.2f}",
        sec_t_fp32=f"{s_t:.2f}", sec_uccsd_fp64=f"{s_cc64:.2f}")
    del c32, c64, l1, l2
    out = []
    for d in (dev, cpu):
        pt, s_e = seconds(torch, lambda: DFUMP2(mf, device=d,
                                                dtype=f64).run())
        rel, s_r = seconds(torch, lambda: pt.make_rdm1(relaxed=True))
        out.append((pt.e_corr, rel.cpu(), s_e, s_r))
    de = abs(out[0][0] - out[1][0])
    ddm = float((out[0][1] - out[1][1]).abs().max())
    d_tr = float(torch.trace(out[0][1] @ torch.as_tensor(
        mf.get_ovlp()))) - mf.mol.nelectron
    if not (de < 1e-8 and ddm < 1e-8 and abs(d_tr) < 1e-8):
        raise RuntimeError(f"DF-UMP2 card vs CPU: dE {de}, ddm {ddm}, "
                           f"trace-N {d_tr}")
    say(9, "OH(H2O)3 dfump2 fp64 ok", e_corr=repr(out[0][0]),
        d_cpu=f"{de:.2e}", max_abs_ddm_cpu=f"{ddm:.2e}",
        relaxed_trace_err=f"{d_tr:.2e}", sec_energy=f"{out[0][2]:.3f}",
        sec_relaxed=f"{out[0][3]:.3f}", sec_relaxed_cpu=f"{out[1][3]:.3f}",
        seconds=f"{time.perf_counter() - t0:.1f}")

    # (c) the OH(H2O)3/cc-pVTZ shape in fp32 on synthetic integrals
    na, nb, va, vb, naux = OS_SHAPE
    er = testing.synthetic_ueris(na, nb, va, vb, naux, device=dev,
                                 dtype=f32, seed=0)
    _, t1, t2 = uccsd.init_amps(er)
    base = torch.cuda.memory_allocated()
    uccsd.update_amps(t1, t2, er)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        (a1, a2), sec = seconds(torch, lambda: uccsd.update_amps(t1, t2, er))
        times.append(sec)
    peak = torch.cuda.max_memory_allocated()
    sweep = statistics.median(times)
    er64 = uccsd.UERIs(*(x.double() if torch.is_tensor(x) else x
                         for x in er))
    t64 = [tuple(x.double() for x in t1), tuple(x.double() for x in t2)]
    (_, b2), sec64 = seconds(torch, lambda: uccsd.update_amps(*t64, er64))
    rel = max(float(torch.linalg.norm(a.double() - b) / torch.linalg.norm(b))
              for a, b in zip(a2, b2))
    if not (rel < RTOL_SWEEP_FP32
            and all(torch.isfinite(x).all() for x in (*a1, *a2))):
        raise RuntimeError(f"open-shell fp32 sweep vs fp64: {rel}")
    del a1, a2, b2
    # the host's share of a sweep: seinsum's own CPU time (the spin-case
    # enumeration, outside the aten ops it launches) from torch.profiler
    from torch.profiler import ProfilerActivity, profile, record_function
    orig = uccsd.seinsum

    host = [0.0]     # host seconds inside seinsum, its launches included

    def traced(*args):
        t = time.perf_counter()
        with record_function("seinsum"):
            out = orig(*args)
        host[0] += time.perf_counter() - t
        return out

    uccsd.seinsum = traced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            uccsd.update_amps(t1, t2, er)
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
    finally:
        uccsd.seinsum = orig
    # the CPU-side entry of the range (a GPU annotation of the same name,
    # with no CPU time, can come with it)
    se = max((e for e in prof.key_averages() if e.key == "seinsum"),
             key=lambda e: e.self_cpu_time_total)
    dev_us = sum(getattr(e, "device_time_total", 0) or 0
                 for e in prof.key_averages()
                 if e.key != "seinsum" and not e.key.startswith("aten::"))
    say(9, "OH(H2O)3/cc-pVTZ-shape uccsd sweep fp32", shape=json.dumps(
        OS_SHAPE), sec=" ".join(f"{t:.4f}" for t in times),
        sec_median=f"{sweep:.4f}", peak_gib=f"{peak / 2**30:.2f}",
        base_gib=f"{base / 2**30:.2f}", rel_t2_fp32_fp64=f"{rel:.3e}",
        sec_fp64=f"{sec64:.3f}", seinsum_calls=se.count,
        seinsum_self_cpu_s=f"{se.self_cpu_time_total / 1e6:.4f}",
        seinsum_cpu_s=f"{se.cpu_time_total / 1e6:.4f}",
        seinsum_host_wall_s=f"{host[0]:.4f}",
        profiled_sweep_wall_s=f"{wall:.4f}",
        device_kernel_s=f"{dev_us / 1e6:.4f}",
        seinsum_host_share=f"{se.self_cpu_time_total / 1e6 / wall:.3f}",
        card=json.dumps(smi), clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    del prof

    # two CCSD cycles on each ring, damped by a level shift as in phase
    # 7(c) (the synthetic iterates are not a molecule's)
    shift, ring = 1e9, {}
    for backend in ("host", "device"):
        (_, e, c1, c2), s2 = seconds(torch, lambda: uccsd.kernel(
            er, max_cycle=2, conv_tol=0.0, t1=t1, t2=t2, level_shift=shift,
            diis_backend=backend))
        if not (all(torch.isfinite(x).all() for x in (*c1, *c2))
                and abs(e) < float("inf")):
            raise RuntimeError(f"open-shell {backend} ring: E {e}")
        ring[backend] = s2 / 2
        del c1, c2
    # two Lambda cycles (device ring; l = t, the MP2 amplitudes)
    torch.cuda.reset_peak_memory_stats()
    (_, lb1, lb2), s_lam = seconds(torch, lambda: lambda_ad.kernel_u(
        t1, t2, er, max_cycle=2, conv_tol=0.0, diis_backend="device"))
    peak_l = torch.cuda.max_memory_allocated()
    if not all(torch.isfinite(x).all() for x in (*lb1, *lb2)):
        raise RuntimeError("non-finite open-shell Lambda multipliers")
    del lb1, lb2
    torch.cuda.reset_peak_memory_stats()
    e_lag, s_lag = seconds(torch, lambda: float(
        lambda_ad.lagrangian_energy_u(*t64, *t64, er64)))
    peak_lag = torch.cuda.max_memory_allocated()
    if not abs(e_lag) < float("inf"):
        raise RuntimeError(f"non-finite open-shell Lagrangian {e_lag}")
    del er64, t64
    say(9, "OH(H2O)3/cc-pVTZ-shape cycles fp32", level_shift=shift,
        sec_ccsd_cycle_host=f"{ring['host']:.3f}",
        sec_ccsd_cycle_device=f"{ring['device']:.3f}",
        sec_lambda_cycle=f"{s_lam / 2:.3f}",
        lambda_sweeps=f"{s_lam / 2 / sweep:.2f}",
        lambda_peak_gib=f"{peak_l / 2**30:.2f}",
        sec_lagrangian_fp64=f"{s_lag:.3f}",
        lagrangian_peak_gib=f"{peak_lag / 2**30:.2f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))

    # the 64-tile UCCSD(T) probe through the entry point, and DF-UMP2
    orig_trips = uccsd_t._tile_triples
    uccsd_t._tile_triples = lambda nvt: orig_trips(nvt)[:NPROBE]
    try:
        uccsd_t.kernel(t1, t2, er, tile=TILE)
        torch.cuda.reset_peak_memory_stats()
        e_tp, s_tp = seconds(torch, lambda: uccsd_t.kernel(t1, t2, er,
                                                           tile=TILE))
    finally:
        uccsd_t._tile_triples = orig_trips
    peak_t = torch.cuda.max_memory_allocated()
    if not abs(e_tp) < float("inf"):
        raise RuntimeError(f"non-finite UCCSD(T) probe {e_tp}")
    ms_tile = s_tp / NPROBE * 1e3
    mo_e = [(e[:n], e[n:]) for e, n in zip(er.mo_energy, (na, nb))]
    ms_mp2 = cuda_ms(torch, lambda: ump2.df_kernel(mo_e, er.Lov_a,
                                                   er.Lov_b), 5)
    # where the time of a (T) tile and of a sweep goes
    big = uccsd_t._prepare(t1, t2, er, TILE, f32, None, None)
    abc = uccsd_t._tile_triples(big["nvp"] // TILE)[NPROBE - 1]
    tile_e = uccsd_t.make_tile_energy(big)
    say(9, "(T) tile trace", tile=json.dumps(abc.tolist()),
        top=json.dumps(trace_top(torch, lambda: tile_e(abc), 3)))
    del big, tile_e
    say(9, "uccsd sweep trace", top=json.dumps(trace_top(
        torch, lambda: uccsd.update_amps(t1, t2, er), 1, k=8)))
    say(9, "OH(H2O)3/cc-pVTZ-shape (T) probe fp32", tiles=NPROBE,
        ms_per_tile=f"{ms_tile:.3f}", tiles_full=OS_NTRIPS,
        sec_full_estimate=f"{ms_tile * OS_NTRIPS / 1e3:.1f}",
        peak_gib=f"{peak_t / 2**30:.2f}", e_probe=repr(e_tp),
        ump2_df_kernel_ms=f"{ms_mp2:.3f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    return mf


def umpcc_phase(torch, smi, dev, mf_df):
    """Phase 10: the open-shell MP-CC layer on the card (no hand kernel on
    it).  (a) O2/sto-3g and H2O/6-31g pins in fp64 and the same solves in
    fp32; (b) OH(H2O)3/cc-pVDZ: UMPCC coupled to the active T3 on phase
    9(b)'s DF-UHF and the fragmented chain on an exact UHF, in fp32,
    against the JAX package's TPU records; (c) the OH(H2O)3/cc-pVTZ shape
    on synthetic integrals in fp32.  mf_df: phase 9(b)'s DF-UHF."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile, record_function

    from pyscf_mpcc_tpu_torch import gto, testing
    from pyscf_mpcc_tpu_torch import scf as pscf
    from pyscf_mpcc_tpu_torch.cc import ccsdt_act, ccsdt_env, uccsd
    from pyscf_mpcc_tpu_torch.cc.spinsum import t2_st
    from pyscf_mpcc_tpu_torch.examples import umpcc_oh
    from pyscf_mpcc_tpu_torch.mp import ump2
    from pyscf_mpcc_tpu_torch.mpcc import masks as mpcc_masks
    from pyscf_mpcc_tpu_torch.mpcc import oomp2, umpccsd, workflow

    f64, f32 = torch.float64, torch.float32
    tol = {f64: dict(conv_tol=1e-11, conv_tol_normt=1e-9, max_cycle=100),
           f32: TOL_FP32}
    freeze = dict(idx_s=[], idx_d=list(range(15)))
    pins = UMPCC_PINS

    def uhf(atom, basis, spin):
        mf = pscf.UHF(gto.M(atom=atom, basis=basis, spin=spin))
        mf.conv_tol, mf.conv_tol_grad = 1e-12, 1e-9
        return mf.run()

    def bitwise(xs, baths, ms):
        return all(bool(m.any()) and torch.equal(x[m], b[m])
                   for x, b, m in zip(xs, baths, ms))

    def fmasks(space, t1, idx_s, idx_d):
        return umpccsd.frozen_masks_u(
            *space, tuple(x.shape[0] for x in t1),
            tuple(x.shape[1] for x in t1),
            *umpccsd._index_lists(idx_s, idx_d), device=dev)

    # (a) the pins in fp64 and the same solves in fp32
    t0 = time.perf_counter()
    o2 = uhf(O2_ATOM, "sto-3g", 2)
    h2o = uhf(H2O_ATOM, "6-31g", 0)
    eri = gto.intor_eri(h2o.mol)
    nao = eri.shape[0]
    w, v = np.linalg.eigh(eri.reshape(nao * nao, nao * nao))
    b_ao = (v[:, w > 1e-12] * np.sqrt(w[w > 1e-12])).T.reshape(-1, nao, nao)
    B_h2o = tuple(np.einsum("Lmn,mp,nq->Lpq", b_ao, c, c, optimize=True)
                  for c in h2o.mo_coeff)
    h_h2o = tuple(c.T @ h2o.get_hcore() @ c for c in h2o.mo_coeff)
    for dt in (f64, f32):
        got = {}
        er = uccsd.eris_from_scf(o2, dt, device=dev)
        _, t1_0, bath = uccsd.init_amps(er)
        got["ump2"] = umpccsd.kernel(er, ([0], [0]), ([0], [0]),
                                     list(range(4)), list(range(16)),
                                     **tol[dt])
        got["uccsd"] = umpccsd.kernel(er, ([0], [0]), ([0], [0]), [], [],
                                      **tol[dt])
        got["partial"] = umpccsd.kernel(er, *O2_SPACE, **freeze, **tol[dt])
        conv, _, t1, t2 = got["partial"]
        ok = bitwise(t2, bath, fmasks(O2_SPACE, t1, **freeze)[2:])
        relax_m = fmasks(O2_SPACE, t1, [3], [15])
        for var in oomp2.VARIANTS:
            got[var] = umpccsd.kernel(er, *O2_SPACE, [3], [15], t1=t1, t2=t2,
                                      oo_mp2=True, oomp2_variant=var,
                                      **tol[dt])
            ok = ok and bitwise((*got[var][2], *got[var][3]), (*t1, *t2),
                                relax_m)
        lconv, l1, l2 = umpccsd.lambda_kernel(
            er, t1, t2, *O2_SPACE, **freeze, max_cycle=100,
            conv_tol=1e-10 if dt == f64 else 3e-6)
        lnorm = float(sum((x.double() ** 2).sum() for x in (*l1, *l2))) ** 0.5
        er = uccsd.eris_from_scf(h2o, dt, device=dev)
        _, _, bath = uccsd.init_amps(er)
        got["pert_df"] = umpccsd.kernel_pert_df(
            er, B_h2o, h_h2o, *H2O_SPACE, **freeze, model="ccsdt-3",
            **tol[dt])
        _, _, t1, t2, t3 = got["pert_df"]
        ok = ok and bitwise(t2, bath, fmasks(H2O_SPACE, t1, **freeze)[2:])
        env = {m: ccsdt_env.kernel(B_h2o, h_h2o, t1, t2, h2o.mol.nelec,
                                   *H2O_SPACE, tuple(h2o.mo_energy),
                                   model=m, device=dev, dtype=dt,
                                   conv_tol=1e-8 if dt == f64 else 1e-6)
               for m in ("ccsdt-1", "ccsdt-3")}
        d = {k: got[k][1] - (pins[k] if k != "uccsd" else
                             OS_PIN_CASES[0][4][1])
             for k in got}
        d.update({"env_" + m: env[m][0] - pins["env_" + m] for m in env})
        d_l = lnorm - pins["lambda_norm"]
        atol = 1e-9 if dt == f64 else ATOL_MAIN_FP32
        dtype_ok = (t3["aabaab"].dtype == dt and t2[1].dtype == dt
                    and env["ccsdt-3"][1]["aabaab"].dtype == dt
                    and got[oomp2.VARIANTS[-1]][3][1].dtype == dt)
        if not (ok and dtype_ok and lconv and all(g[0] for g in got.values())
                and all(x[2] for x in env.values())
                and all(abs(x) < atol for x in d.values())
                and abs(d_l) < (1e-8 if dt == f64 else 1e-5)):
            raise RuntimeError(
                f"open-shell MP-CC pins {dt}: differences {d}, Lambda norm "
                f"{d_l}, frozen blocks bit for bit {ok}, dtypes {dtype_ok}, "
                f"converged {[k for k, g in got.items() if not g[0]]} not, "
                f"Lambda {lconv}, env {[x[2] for x in env.values()]}")
        say(10, f"pins {str(dt)[6:]} ok", atol=atol,
            max_abs_d=f"{max(abs(x) for x in d.values()):.1e}",
            d=json.dumps({k: f"{x:.1e}" for k, x in d.items()}),
            d_lambda_norm=f"{d_l:.1e}", frozen_bitwise=ok)
    say(10, "pins done", seconds=f"{time.perf_counter() - t0:.1f}")
    del er, bath, t1, t2, t3, l1, l2

    # (b) OH(H2O)3/cc-pVDZ in fp32 against the JAX package's TPU records
    t0 = time.perf_counter()
    et, sec_t = umpcc_oh.t3_coupling(mf_df, OH3_N_ACT, device=dev,
                                     dtype=f32)
    d_t = tuple(et[k] - REC_OH3[k] for k in ("uccsd", "uccsd_t3",
                                             "coupling"))
    if not (abs(d_t[0]) < ATOL_REC and abs(d_t[1]) < ATOL_REC
            and abs(d_t[2]) < ATOL_COUPLING):
        raise RuntimeError(f"OH(H2O)3 UMPCC+T3 against the record: {d_t} "
                           f"({et})")
    say(10, "OH(H2O)3/cc-pVDZ umpcc+t3 fp32 ok",
        n_act=f"{OH3_N_ACT}+{OH3_N_ACT}",
        e_uccsd=repr(et["uccsd"]), e_uccsd_t3=repr(et["uccsd_t3"]),
        coupling=f"{et['coupling']:.4e}", d_uccsd=f"{d_t[0]:.2e}",
        d_uccsd_t3=f"{d_t[1]:.2e}", d_coupling=f"{d_t[2]:.2e}",
        sec=json.dumps({k: round(x, 2) for k, x in sec_t.items()}))
    # the chain on an exact UHF, timed inside the calls: the host parts
    # (PM localization, the ERI transforms, the mask builds) and the
    # solves (the UMP2 baths, the UMPCC kernels and the UCCSD sweeps in
    # them; the global references of umpcc_oh.chain included)
    wrapped = ((workflow, "localize_occ_vir_u", "pm"),
               (uccsd, "make_eris_incore", "eris"),
               (umpccsd, "frozen_masks_u", "masks"),
               (ump2, "iterative_kernel", "bath"),
               (umpccsd, "kernel", "umpcc"),
               (uccsd, "update_amps", "sweeps"))
    orig = {k: getattr(mod, name) for mod, name, k in wrapped}
    host = {k: 0.0 for k in orig}
    calls = {k: 0 for k in orig}

    def timed(key):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[key](*args, **kwargs)
            torch.cuda.synchronize()
            host[key] += time.perf_counter() - t
            calls[key] += 1
            return out
        return call

    t1_ = time.perf_counter()
    mf = umpcc_oh.exact_uhf()
    eri = gto.intor_eri(mf.mol)
    s_uhf = time.perf_counter() - t1_
    try:
        for mod, name, k in wrapped:
            setattr(mod, name, timed(k))
        ec, sec_c = umpcc_oh.chain(mf, ("chain",), eri,
                                   device=dev, dtype=f32)
    finally:
        for mod, name, k in wrapped:
            setattr(mod, name, orig[k])
    d_c = {k: ec[k] - REC_OH3["frag_" + k]
           for k in ("mp2", "chain", "uccsd")}
    if not all(abs(x) < ATOL_REC for x in d_c.values()):
        raise RuntimeError(f"OH(H2O)3 fragmented chain against the record: "
                           f"{d_c} ({ec})")
    gap = ec["uccsd"] - ec["mp2"]
    say(10, "OH(H2O)3/cc-pVDZ fragmented chain fp32 ok",
        e_uhf=repr(mf.e_tot),
        e=json.dumps({k: repr(x) for k, x in ec.items()}),
        fraction_chain=f"{(ec['chain'] - ec['mp2']) / gap:.4f}",
        d_record=json.dumps({k: f"{x:.2e}" for k, x in d_c.items()}),
        sec_uhf_host=f"{s_uhf:.1f}",
        sec=json.dumps({k: round(x, 2) for k, x in sec_c.items()}),
        timed_sec=json.dumps({k: round(x, 2) for k, x in host.items()}),
        timed_calls=json.dumps(calls),
        seconds=f"{time.perf_counter() - t0:.1f}")
    del mf, eri

    # (c) the OH(H2O)3/cc-pVTZ shape in fp32 on synthetic integrals,
    # cycles damped by a level shift as in phase 9(c)
    na, nb, va, vb, naux = OS_SHAPE
    shift = 1e9
    er = testing.synthetic_ueris(na, nb, va, vb, naux, device=dev,
                                 dtype=f32, seed=0)
    _, t1, t2 = uccsd.init_amps(er)
    q = (([*range(na - na // 4, na)], [*range(nb - nb // 4, nb)]),
         ([*range(va // 4)], [*range(vb // 4)]))
    _, s_mask = seconds(torch, lambda: umpccsd.frozen_masks_u(
        *q, (na, nb), (va, vb), *umpccsd._index_lists(**freeze), device=dev))
    cyc = {}
    for ring in ("host", "device"):
        torch.cuda.reset_peak_memory_stats()
        (_, e, c1, c2), s2 = seconds(torch, lambda: umpccsd.kernel(
            er, *q, **freeze, t1=t1, t2=t2, max_cycle=2, conv_tol=0.0,
            level_shift=shift, diis_backend=ring))
        if not all(torch.isfinite(x).all() for x in (*c1, *c2)):
            raise RuntimeError(f"masked UMPCC {ring} ring not finite")
        cyc[ring] = ((s2 - s_mask) / 2, torch.cuda.max_memory_allocated())
        del c1, c2
    act_m = tuple(torch.as_tensor(m[15], device=dev) for m in (
        mpcc_masks.doubles_blocks(q[0][0], q[1][0], na, va),
        mpcc_masks.doubles_blocks(q[0][0], q[1][0], na, va, q[0][1], q[1][1],
                                  nb, vb),
        mpcc_masks.doubles_blocks(q[0][1], q[1][1], nb, vb)))
    oo = {}
    for var in oomp2.VARIANTS:
        oomp2.update_amps_oomp2(t1, t2, er, variant=var, act_masks=act_m)
        torch.cuda.reset_peak_memory_stats()
        (u1, u2), s = seconds(torch, lambda: oomp2.update_amps_oomp2(
            t1, t2, er, variant=var, act_masks=act_m))
        if not all(torch.isfinite(x).all() for x in (*u1, *u2)):
            raise RuntimeError(f"OO-MP2 {var} sweep not finite")
        oo[var] = (s, torch.cuda.max_memory_allocated())
        del u1, u2
    say(10, "OH(H2O)3/cc-pVTZ-shape masked umpcc and oo-mp2 fp32",
        shape=json.dumps(OS_SHAPE), active="quarter", level_shift=shift,
        sec_mask_build=f"{s_mask:.3f}",
        sec_cycle_host=f"{cyc['host'][0]:.3f}",
        sec_cycle_device=f"{cyc['device'][0]:.3f}",
        peak_gib_host=f"{cyc['host'][1] / 2**30:.2f}",
        peak_gib_device=f"{cyc['device'][1] / 2**30:.2f}",
        oomp2_sec=json.dumps({k: round(x[0], 4) for k, x in oo.items()}),
        oomp2_peak_gib=json.dumps({k: round(x[1] / 2**30, 2)
                                   for k, x in oo.items()}),
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))

    # one kernel_pert_df cycle at OH3_N_ACT active, split into its parts
    B, h = testing.synthetic_ufactors(na, nb, va, vb, naux, device=dev,
                                      dtype=f32, seed=0)
    n = OH3_N_ACT
    a10 = (([*range(na - n, na)], [*range(nb - n, nb)]),
           ([*range(n)], [*range(n)]))
    dd = ccsdt_act.DressedDF((na, nb), (na + va, nb + vb), *a10, device=dev)
    d3 = ccsdt_act.d3_blocks(dd, er.mo_energy)
    arrs = ccsdt_act.dress_df(B, h, t1, (na, nb))
    T2 = t2_st(t2)
    drive = ccsdt_act.reduce_t3(ccsdt_act.t3_residual_act(
        T2, None, dd, arrs, model="ccsdt-3"))
    canon = {k: v / d3[k] for k, v in drive.items()}
    parts = {
        "dress_df": lambda: ccsdt_act.dress_df(B, h, t1, (na, nb)),
        "t3_residual": lambda: ccsdt_act.reduce_t3(
            ccsdt_act.t3_residual_act(T2, ccsdt_act.expand_t3(canon), dd,
                                      arrs, model="ccsdt-3")),
        "feedback": lambda: ccsdt_act.feedback_act(
            ccsdt_act.expand_t3(canon), dd, arrs),
        "uccsd_update": lambda: uccsd.update_amps(t1, t2, er, shift)}
    sec_p = {}
    for k, fn in parts.items():
        fn()
        sec_p[k] = statistics.median(seconds(torch, fn)[1] for _ in range(3))
    # seinsum's host share of the four parts (its own CPU time outside the
    # aten ops it launches, torch.profiler), as phase 9(c) for the sweep
    se_orig = ccsdt_act.seinsum
    hostw = [0.0]

    def traced(*args):
        t = time.perf_counter()
        with record_function("seinsum"):
            out = se_orig(*args)
        hostw[0] += time.perf_counter() - t
        return out

    ccsdt_act.seinsum = uccsd.seinsum = traced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            w0 = time.perf_counter()
            for fn in parts.values():
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
    finally:
        ccsdt_act.seinsum = uccsd.seinsum = se_orig
    se = max((e for e in prof.key_averages() if e.key == "seinsum"),
             key=lambda e: e.self_cpu_time_total)
    del prof
    torch.cuda.reset_peak_memory_stats()
    (_, e, c1, c2, c3), s_pd = seconds(torch, lambda: umpccsd.kernel_pert_df(
        er, B, h, *a10, [], [], model="ccsdt-3", t1=t1, t2=t2, max_cycle=2,
        conv_tol=0.0, level_shift=shift))
    peak_pd = torch.cuda.max_memory_allocated()
    if not (all(torch.isfinite(x).all() for x in (*c1, *c2, *c3.values()))
            and c3["aaaaaa"].dtype == f32):
        raise RuntimeError("kernel_pert_df cycle not finite")
    del c1, c2, c3, arrs, drive, canon, B, h, dd, d3
    say(10, "OH(H2O)3/cc-pVTZ-shape kernel_pert_df fp32", n_act=f"{n}+{n}",
        sec_two_cycles=f"{s_pd:.3f}",
        sec_parts=json.dumps({k: round(x, 4) for k, x in sec_p.items()}),
        peak_gib=f"{peak_pd / 2**30:.2f}", seinsum_calls=se.count,
        seinsum_self_cpu_s=f"{se.self_cpu_time_total / 1e6:.4f}",
        seinsum_host_wall_s=f"{hostw[0]:.4f}",
        profiled_parts_wall_s=f"{wall:.4f}",
        seinsum_host_share=f"{se.self_cpu_time_total / 1e6 / wall:.3f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    del er, t1, t2

    # one solve_t3_env sweep at 2+2 active (the virtual ranges cut: the
    # environment t3 is o^3 v^3 a block, 6.2e10 elements at the full shape)
    na, nb, va, vb, naux = ENV_SHAPE
    er = testing.synthetic_ueris(*ENV_SHAPE, device=dev, dtype=f32, seed=0)
    B, h = testing.synthetic_ufactors(*ENV_SHAPE, device=dev, dtype=f32,
                                      seed=0)
    _, t1, t2 = uccsd.init_amps(er)
    a2 = (([na - 2, na - 1], [nb - 2, nb - 1]), ([0, 1], [0, 1]))
    arrs = ccsdt_act.dress_df(B, h, t1, (na, nb))
    torch.cuda.reset_peak_memory_stats()
    (t3e, _), s_env = seconds(torch, lambda: ccsdt_env.solve_t3_env(
        t2, (na, nb), (na + va, nb + vb), *a2, arrs, er.mo_energy,
        model="ccsdt-3", max_cycle=1, conv_tol=0.0, diis_space=0))
    peak_env = torch.cuda.max_memory_allocated()
    if not all(torch.isfinite(x).all() for x in t3e.values()):
        raise RuntimeError("environment t3 sweep not finite")
    say(10, "env t3 sweep fp32", shape=json.dumps(ENV_SHAPE), n_act="2+2",
        t3_elements=sum(x.numel() for x in t3e.values()),
        sec_drive_and_sweep=f"{s_env:.3f}", peak_gib=f"{peak_env / 2**30:.2f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))


def spinorb_phase(torch, smi, dev):
    """Phase 11: the (T)-response and spin-orbital layer on the card.
    (a) pins in fp64: QCISD(T) of H2O/cc-pVDZ through the combine kernel
    (chunk 1 and 4), the resident kernel and engine='xla', CH4 QCISD,
    BCCD(T), the R/U/G (T) energies, Lambda(T) and RDM identities, GMP2,
    DF-GMP2, kernel_pert_triples' limits, the device DF J/K; (b) the same
    solves in fp32 (the resident kernel through engine='auto' at
    dot_precision='high'); (c) (H2O)2/cc-pVTZ frozen core in fp32:
    QCISD(mf).run().ccsd_t(), BCCD(T), each with its first 16 tiles held
    against engine='xla', the restricted Lambda(T) and make_rdm12,
    DF-GMP2.  Returns the combine/chunk/resident kernel launches of the
    phase by dtype ({'fp32': {...}, 'fp64': {...}}), each counted from 0
    just before its runs; launches that only compare a kernel with
    engine='xla' are in neither."""
    import numpy as np

    from pyscf_mpcc_tpu_torch import ao2mo, gto, testing
    from pyscf_mpcc_tpu_torch import scf as pscf
    from pyscf_mpcc_tpu_torch.cc import (bccd, ccsd_t, ccsd_t_rdm,
                                         eom_slow, gccsd, gccsd_slow,
                                         gccsd_t_rdm, gccsdt_slow,
                                         lambda_ad, qcisd, rccsd, uccsd,
                                         uccsd_t_rdm)
    from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
    from pyscf_mpcc_tpu_torch.mp import dfgmp2, gmp2
    from pyscf_mpcc_tpu_torch.mpcc import umpccsd
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    from pyscf_mpcc_tpu_torch.scf.hf import _JKDF

    f64, f32 = torch.float64, torch.float32
    tight = {f64: dict(conv_tol=1e-11, conv_tol_normt=1e-9, max_cycle=100),
             f32: TOL_FP32}
    # the phase's kernel launches by dtype.  The fp32 tally joins rows 1-3
    # of the kernel record, whose times are fp32 readings; its resident
    # launches all come through dot_precision='high', mode split, the mode
    # the resident row times.  The fp64 tally (the combine kernel in fp64,
    # the resident kernel in mode f32) is reported beside the record.
    launches = {dt: {"fused": 0, "chunk": 0, "resident": 0}
                for dt in (f32, f64)}

    def counted(kind, fn, dt):
        """fn() with the kind's kernel count zeroed just before and read
        just after, added to dt's tally; returns (fn(), launches)."""
        mod = tr if kind == "resident" else tc
        mod.launch_count = 0
        out = fn()
        n = mod.launch_count
        launches[dt][kind] += n
        return out, n

    def uncounted(kind, fn):
        """fn() for a comparison with engine='xla': raises if the kind's
        kernel did not launch; the launches join no tally."""
        mod = tr if kind == "resident" else tc
        n0 = mod.launch_count
        out = fn()
        if mod.launch_count == n0:
            raise RuntimeError(f"{kind} comparison launched no kernel")
        return out

    @contextlib.contextmanager
    def tiles(lo, hi):
        """ccsd_t.kernel runs only the tiles lo:hi of its triangle."""
        orig = ccsd_t._tile_triples
        ccsd_t._tile_triples = lambda nvt: orig(nvt)[lo:hi]
        try:
            yield
        finally:
            ccsd_t._tile_triples = orig

    def by_tile(inp, tile, vfac):
        """Each tile's E(T) of inp, one ccsd_t.kernel call a tile, through
        engine='xla' and both kernels at full precision (comparison
        launches)."""
        ntile = len(ccsd_t._tile_triples(-(-inp[0].shape[1] // tile)))
        out = {"xla": [], "fused": [], "resident": []}
        for n in range(ntile):
            with tiles(n, n + 1):
                for k, v in out.items():
                    def run():
                        return ccsd_t.kernel(*inp, tile=tile, vfac=vfac,
                                             engine=k)
                    v.append(run() if k == "xla" else uncounted(k, run))
        return {k: np.array(v) for k, v in out.items()}

    def probe(inp, tile, vfac, what):
        """The first NPROBE_SO tiles of inp through the combine kernel and
        the resident kernel (dot_precision='high', mode split) against
        engine='xla', each timed warm (comparison launches); raises beyond
        RTOL_TILE_FP32 and RTOL_SPLIT.  Returns ({engine: (E, s)},
        {kernel: relative difference})."""
        def run(**kw):
            return ccsd_t.kernel(*inp, tile=tile, vfac=vfac, **kw)
        with tiles(0, NPROBE_SO):
            p = {"xla": seconds(torch, lambda: run(engine="xla"))}
            for kind, kw in (("fused", dict(engine="fused")),
                             ("resident", dict(dot_precision="high"))):
                run(**kw)
                p[kind] = uncounted(kind, lambda: seconds(
                    torch, lambda: run(**kw)))
        rel = {k: abs(p[k][0] / p["xla"][0] - 1)
               for k in ("fused", "resident")}
        if not (rel["fused"] < RTOL_TILE_FP32
                and rel["resident"] < RTOL_SPLIT):
            raise RuntimeError(f"{what}: first {NPROBE_SO} tiles against "
                               f"xla: {rel}")
        return p, rel

    def mean_field(cls, atom, basis, spin=0, unit="angstrom", df=False):
        mf = getattr(pscf, cls)(gto.M(atom=atom, basis=basis, spin=spin,
                                      unit=unit))
        if df:
            mf = mf.density_fit()
        mf.conv_tol = 1e-12
        mf.conv_tol_grad = 1e-9
        mf.kernel()
        if not mf.converged:
            raise RuntimeError(f"{cls} {atom} {basis} unconverged")
        return mf

    def finite(*xs):
        return all(bool(torch.isfinite(x).all()) for x in xs)

    # host mean fields, shared by (a) and (b)
    h2o = mean_field("RHF", testing.GEOMS["sym"], "cc-pvdz")
    tilt = mean_field("RHF", testing.GEOMS["tilt"], "cc-pvdz")
    h2o_min = mean_field("RHF", DFGMP2_ATOM, "sto-3g")
    oh_u = mean_field("UHF", "O 0 0 0; H 0 0 0.97", "6-31g", spin=1)
    oh_g = mean_field("GHF", "O 0 0 0; H 0 0 0.97", "sto-3g", spin=1)
    eri_min = gto.intor_eri(h2o_min.mol)

    def solves(dt):
        """The (a)/(b) energies on the card in dtype dt."""
        t0 = time.perf_counter()
        r = {}
        # QCISD(T) of H2O/cc-pVDZ through every (T) engine
        q = qcisd.QCISD(h2o, device=dev, dtype=dt)
        q.conv_tol, q.conv_tol_normt = (tight[dt]["conv_tol"],
                                        tight[dt]["conv_tol_normt"])
        q.run()
        if not (q.converged and q.t2.dtype == dt):
            raise RuntimeError(f"QCISD {dt} unconverged")
        r["qcisd"] = q.e_corr
        resident = (dict(engine="resident") if dt == f64
                    else dict(dot_precision="high"))
        for name, kind, kw in (("t_fused", "fused", {}),
                               ("t_chunk4", "chunk", dict(engine="fused",
                                                          chunk=4)),
                               ("t_resident", "resident", resident),
                               ("t_xla", None, dict(engine="xla"))):
            if kind is None:
                r[name] = q.ccsd_t(**kw)
                continue
            r[name], n = counted(kind, lambda: q.ccsd_t(**kw), dt)
            if n == 0:
                raise RuntimeError(f"QCISD(T) {name} launched no kernel")
        t_tiles = by_tile(q.triples_inputs(), 4, 2.0) if dt == f64 else None
        del q
        # BCCD(T) of H2O/sto-3g: t1 = 0 through both kernels and 'xla', on
        # the inputs bccd.kernel_t builds (its body, step by step)
        e_b, mo_b, bt2, _ = bccd.kernel(
            h2o_min, eri_min, t1_tol=1e-7 if dt == f64 else 1e-5,
            cc_conv=tight[dt]["conv_tol"],
            cc_conv_normt=tight[dt]["conv_tol_normt"], device=dev,
            dtype=dt)
        inp = bccd.triples_inputs(h2o_min, eri_min, mo_b, bt2)
        r["bccd"] = e_b
        for name, kind, kw in (("bccd_t", "fused", {}),
                               ("bccd_t_resident", "resident", resident),
                               ("bccd_t_xla", None, dict(engine="xla"))):
            def run():
                return ccsd_t.kernel(*inp, tile=bccd.TILE_T, **kw)
            if kind is None:
                r[name] = run()
                continue
            r[name], n = counted(kind, run, dt)
            if n == 0:
                raise RuntimeError(f"BCCD(T) {name} launched no kernel")
        del inp, bt2
        # restricted (T) functional at the tilted geometry's CCSD
        er = eris_mod.make_eris_incore(gto.intor_eri(tilt.mol),
                                       tilt.mo_coeff,
                                       tilt.get_fock(tilt.make_rdm1()), 5,
                                       dt, device=dev)
        c, _, t1, t2 = rccsd.kernel(er, **tight[dt])
        if not c:
            raise RuntimeError(f"tilt CCSD {dt} unconverged")
        r["et_dense_tilt"] = float(ccsd_t_rdm.e_t_dense(t1, t2, er))
        # UCCSD(T) functional of OH/6-31g
        eru = uccsd.eris_from_scf(oh_u, dt, device=dev)
        c, _, u1, u2 = uccsd.kernel(eru, **tight[dt])
        if not c:
            raise RuntimeError(f"OH UCCSD {dt} unconverged")
        r["et_u"] = float(uccsd_t_rdm.e_t_dense_u(u1, u2, eru))
        # GCCSD(T) functional of OH/sto-3g GHF
        erg = gccsd.make_eris_ghf(oh_g, dtype=dt, device=dev)
        e_g, g1, g2, c = gccsd.kernel(erg, **tight[dt])
        if not c:
            raise RuntimeError(f"OH GCCSD {dt} unconverged")
        r["gccsd"], r["et_g"] = e_g, float(gccsd_t_rdm.e_t_g(g1, g2, erg))
        # GMP2 and DF-GMP2
        r["gmp2"] = gmp2.GMP2(h2o, device=dev, dtype=dt).run().e_corr
        # (the pins' orbitals are the exact RHF's; DFGMP2 fits the factors)
        for basis in ("sto-3g", "631g"):
            mf = mean_field("RHF", DFGMP2_ATOM, basis)
            r[f"dfgmp2_{basis}"] = dfgmp2.DFGMP2(mf, device=dev,
                                                 dtype=dt).run().e_corr
        extra = dict(tilt=(er, t1, t2), u=(eru, u1, u2), g=(erg, g1, g2),
                     t_tiles=t_tiles)
        return r, extra, time.perf_counter() - t0

    def to_xla(r, names, ref):
        """Each engine's E(T) minus engine='xla''s."""
        return {k: r[k] - r[ref] for k in names}

    q_names = ("t_fused", "t_chunk4", "t_resident")
    b_names = ("bccd_t", "bccd_t_resident")

    # ---- (a) fp64 ------------------------------------------------------
    r64, x64, sec64 = solves(f64)
    dq, db = to_xla(r64, q_names, "t_xla"), to_xla(r64, b_names, "bccd_t_xla")
    # tile by tile: a kernel's fp64 tile energy differs from the plain
    # one's only in the order of its sums
    tt = x64.pop("t_tiles")
    d_tile = {k: float(np.abs(tt[k] - tt["xla"]).max())
              for k in ("fused", "resident")}
    tile_scale = float(np.abs(tt["xla"]).max())
    checks = {
        "qcisd_t_engines": all(abs(d) <= RTOL_FP64 * abs(r64["t_xla"])
                               for d in dq.values())
        and abs(r64["t_xla"]) > 1e-4,
        "qcisd_t_tiles": max(d_tile.values()) <= RTOL_FP64 * tile_scale,
        "bccd_t_engines": all(abs(d) <= RTOL_FP64 * abs(r64["bccd_t_xla"])
                              for d in db.values())
        and r64["bccd_t_xla"] < 0 and abs(r64["bccd"]) > 1e-3,
        "et_tilt_pin": abs(r64["et_dense_tilt"] - E_T_TILT) < 1e-9,
        "uccsd_t_rdm_oh": abs(r64["et_u"] - ET_UCCSD_T_RDM_OH) < 1e-10,
        "gccsd_t_rdm_oh": abs(r64["et_g"] - ET_GCCSD_T_RDM_OH) < 1e-12,
        "gmp2": abs(r64["gmp2"] - E_MP2_SYM) < 1e-9,
        "dfgmp2": all(abs(r64[f"dfgmp2_{b}"] - e) < 1e-9
                      for b, e in E_DFGMP2.items())}
    if not all(checks.values()):
        raise RuntimeError(f"phase 11 fp64 pins: {checks} {r64}")
    say(11, "spin-orbital and (T)-response pins fp64 ok",
        **{k: repr(v) for k, v in r64.items()},
        qcisd_t_minus_xla=json.dumps(dq), bccd_t_minus_xla=json.dumps(db),
        rtol=RTOL_FP64, seconds=f"{sec64:.1f}")
    # why the totals can agree to the last bit: the tiles' own differences
    # against the half-ulp of the fp64 running sum
    say(11, "qcisd(t) fp64 tile by tile", tiles=len(tt["xla"]),
        max_abs_tile_diff=json.dumps(d_tile),
        sum_abs_tile_diff=json.dumps({k: float(np.abs(tt[k] - tt["xla"])
                                               .sum())
                                      for k in ("fused", "resident")}),
        max_abs_tile=repr(tile_scale),
        half_ulp_of_total=repr(float(np.spacing(abs(r64["t_xla"])) / 2)),
        tiles_bit_equal=json.dumps({k: int((tt[k] == tt["xla"]).sum())
                                    for k in ("fused", "resident")}))

    t0 = time.perf_counter()
    ch4 = mean_field("RHF", CH4_ATOM, "cc-pvdz")
    q = qcisd.QCISD(ch4, frozen=1, device=dev, dtype=f64)
    q.conv_tol, q.conv_tol_normt = 1e-10, 1e-8
    q.run()
    if not (q.converged and abs(q.e_tot - E_TOT_CH4_QCISD) < 1e-6):
        raise RuntimeError(f"CH4 QCISD {q.e_tot!r} off its pin")
    say(11, "ch4 qcisd pin ok", e_tot=repr(q.e_tot),
        err=f"{q.e_tot - E_TOT_CH4_QCISD:.2e}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    del q

    # Lambda(T) and the (T)-response RDM identities in R, U and G
    t0 = time.perf_counter()
    ident = {}
    er, t1, t2 = x64["tilt"]
    c, l1, l2 = ccsd_t_rdm.lambda_kernel(t1, t2, er, conv_tol=1e-10)
    mo = torch.tensor(tilt.mo_coeff, device=dev, dtype=f64)
    h = mo.T @ torch.tensor(tilt.get_hcore(), device=dev, dtype=f64) @ mo
    g = ao2mo.full(torch.tensor(gto.intor_eri(tilt.mol), device=dev,
                                dtype=f64), mo)
    d1, d2 = ccsd_t_rdm.make_rdm12(h, g, t1, t2, l1, l2, 5)
    e_ccsd = float(rccsd.energy(t1, t2, er))
    ident["r"] = (c, float((d1 * h).sum() + 0.5 * (g * d2).sum())
                  - (tilt.e_tot - tilt.mol.energy_nuc() + e_ccsd
                     + r64["et_dense_tilt"]))
    eru, u1, u2 = x64["u"]
    c, l1, l2 = uccsd_t_rdm.lambda_kernel_u(u1, u2, eru, conv_tol=1e-9,
                                            max_cycle=100)
    moa, mob = (torch.tensor(m, device=dev, dtype=f64)
                for m in oh_u.mo_coeff)
    hao = torch.tensor(oh_u.get_hcore(), device=dev, dtype=f64)
    eri = torch.tensor(gto.intor_eri(oh_u.mol), device=dev, dtype=f64)
    ints = (moa.T @ hao @ moa, mob.T @ hao @ mob, ao2mo.full(eri, moa),
            ao2mo.general(eri, (moa, moa, mob, mob)), ao2mo.full(eri, mob))
    (a1, b1), (aa, ab, bb) = uccsd_t_rdm.make_rdm12(
        *ints, u1, u2, l1, l2, *oh_u.mol.nelec)
    e_dm = float((a1 * ints[0]).sum() + (b1 * ints[1]).sum()
                 + 0.5 * (ints[2] * aa).sum() + 0.5 * (ints[4] * bb).sum()
                 + (ints[3] * ab).sum())
    e_u = float(uccsd.energy(u1, u2, eru))
    ident["u"] = (c, e_dm - (oh_u.e_tot - oh_u.mol.energy_nuc() + e_u
                             + r64["et_u"]))
    erg, g1, g2 = x64["g"]
    c, l1, l2 = gccsd_t_rdm.lambda_kernel_g(g1, g2, erg, conv_tol=1e-9,
                                            max_cycle=100)
    C = torch.tensor(oh_g.mo_coeff, device=dev, dtype=f64)
    eri = torch.tensor(gto.intor_eri(oh_g.mol), device=dev, dtype=f64)
    gch = gccsd._spinor_chem(eri, C, C, C, C)
    nao = oh_g.mol.nao
    h1 = torch.tensor(np.asarray(oh_g.get_hcore())[:nao, :nao], device=dev,
                      dtype=f64)
    hso = C[:nao].T @ h1 @ C[:nao] + C[nao:].T @ h1 @ C[nao:]
    d1, d2 = gccsd_t_rdm.make_rdm12(hso, gch, g1, g2, l1, l2, erg.nocc)
    ident["g"] = (c, float((d1 * hso).sum() + 0.5 * (gch * d2).sum())
                  - (oh_g.e_tot - oh_g.mol.energy_nuc() + r64["gccsd"]
                     + r64["et_g"]))
    if not all(c and abs(d) < ATOL_RDM for c, d in ident.values()):
        raise RuntimeError(f"(T)-response RDM identities: {ident}")
    say(11, "lambda(T) and rdm identities fp64 ok",
        **{f"d_{k}": f"{d:.2e}" for k, (_, d) in ident.items()},
        atol=ATOL_RDM, seconds=f"{time.perf_counter() - t0:.1f}")
    del x64, er, eru, erg, d1, d2, aa, ab, bb, ints, gch, g

    # kernel_pert_triples' limits (the host spin-orbital engines) on H4
    t0 = time.perf_counter()
    h4 = mean_field("RHF", "H 0 0 0; H 0 0 0.9; H 0 0 1.8; H 0 0 2.7",
                    "sto-3g")
    so = gccsd_slow.eris_from_scf(h4)
    kw = dict(conv_tol=1e-11, conv_tol_normt=1e-9)
    e_cc = gccsd_slow.kernel(so, max_cycle=300, **kw)[0]
    e_t = gccsdt_slow.kernel(so, eom_slow.h_so_from_eris(so), model="ccsdt",
                             max_cycle=200, **kw)[0]
    lim = {"ccsd": umpccsd.kernel_pert_triples(
               h4, ([], []), ([], []), [], [], model="ccsdt", **kw),
           "ccsdt": umpccsd.kernel_pert_triples(
               h4, ([0, 1], [0, 1]), ([0, 1], [0, 1]), [], [],
               model="ccsdt", **kw),
           "frozen_bath": umpccsd.kernel_pert_triples(
               h4, ([1], [1]), ([0], [0]), [], list(range(15)),
               model="ccsdt-3", conv_tol=1e-10, conv_tol_normt=1e-8)}
    if not (all(x[-1] for x in lim.values())
            and abs(lim["ccsd"][0] - e_cc) < 1e-9
            and abs(lim["ccsdt"][0] - e_t) < 1e-9
            and abs(lim["frozen_bath"][0] - e_cc) < 0.05):
        raise RuntimeError(f"kernel_pert_triples limits: "
                           f"{[x[0] for x in lim.values()]} {e_cc} {e_t}")
    say(11, "kernel_pert_triples limits ok",
        **{k: repr(float(x[0])) for k, x in lim.items()},
        e_ccsd=repr(float(e_cc)),
        e_ccsdt=repr(float(e_t)), seconds=f"{time.perf_counter() - t0:.1f}")

    # the device DF J/K against the host one
    mfd = mean_field("RHF", testing.GEOMS["sym"], "cc-pvdz", df=True)
    B = mfd.with_df.B_ao()
    dm = mfd.make_rdm1()
    jk = {"host": _JKDF(B).get_jk(dm),
          f64: _JKDF(B, device=dev, dtype=f64).get_jk(dm),
          f32: _JKDF(B, device=dev, dtype=f32).get_jk(dm)}
    mfd._jk = _JKDF(B, device=dev)
    e_dev = mfd.kernel()
    djk = {dt: max(float(np.abs(a - b).max())
                   for a, b in zip(jk[dt], jk["host"])) for dt in (f64, f32)}
    scale = max(float(np.abs(x).max()) for x in jk["host"])
    if not (djk[f64] < 1e-10 and djk[f32] < 1e-5 * scale
            and abs(e_dev - mfd.e_tot) < 1e-12 and mfd.converged):
        raise RuntimeError(f"device DF J/K: {djk} {scale}")
    say(11, "device df j/k ok", max_diff_fp64=f"{djk[f64]:.2e}",
        max_diff_fp32=f"{djk[f32]:.2e}", jk_scale=f"{scale:.3f}",
        rhf_on_card_fp32=repr(e_dev))

    # ---- (b) fp32 ------------------------------------------------------
    r32, x32, sec32 = solves(f32)
    del x32
    d32 = {k: abs(r32[k] - r64[k]) for k in r64}
    if not max(d32.values()) < ATOL_MAIN_FP32:
        raise RuntimeError(f"phase 11 fp32 vs fp64: {d32}")
    say(11, "fp32 vs fp64 ok", max_abs_diff=f"{max(d32.values()):.3e}",
        worst=max(d32, key=d32.get), atol=ATOL_MAIN_FP32,
        qcisd_t_minus_xla_fp32=json.dumps(to_xla(r32, q_names, "t_xla")),
        bccd_t_minus_xla_fp32=json.dumps(to_xla(r32, b_names,
                                                "bccd_t_xla")),
        seconds=f"{sec32:.1f}")

    # ---- (c) (H2O)2/cc-pVTZ frozen core, fp32 ---------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mol = gto.M(atom=testing.W4_GEOM[:6], basis=W2_BASIS)
    mf = pscf.RHF(mol).density_fit()
    mf.conv_tol = 1e-10
    mf.kernel()
    s_scf = time.perf_counter() - t0
    t0 = time.perf_counter()
    eri_ao = gto.intor_eri(mol)
    s_eri = time.perf_counter() - t0
    nfz = 2
    no, nmo = mol.nelectron // 2 - nfz, mol.nao - nfz
    say(11, "(H2O)2/cc-pVTZ host set-up", nao=mol.nao, nocc=no,
        nvir=nmo - no, nso=2 * nmo, scf_converged=mf.converged,
        e_scf=repr(mf.e_tot), sec_df_rhf=f"{s_scf:.1f}",
        sec_ao_eri=f"{s_eri:.1f}")
    if not mf.converged:
        raise RuntimeError("(H2O)2 DF-RHF unconverged")

    # the nine spinor blocks, built on the card one at a time
    torch.cuda.reset_peak_memory_stats()
    ge, s_build = seconds(torch, lambda: qcisd.make_geris_rhf(
        mf, nfz, f32, device=dev))
    peak_build = torch.cuda.max_memory_allocated()
    gib_blocks = nbytes(list(ge.b.values())) / 2**30
    del ge
    torch.cuda.empty_cache()
    # QCISD through the facade, its sweeps counted
    q = qcisd.QCISD(mf, frozen=nfz, device=dev, dtype=f32)
    q.conv_tol, q.conv_tol_normt = (TOL_FP32["conv_tol"],
                                    TOL_FP32["conv_tol_normt"])
    upd, nsweep = gccsd._update, [0]

    def counting(*a, **k):
        nsweep[0] += 1
        return upd(*a, **k)

    gccsd._update = counting
    torch.cuda.reset_peak_memory_stats()
    try:
        _, s_run = seconds(torch, q.run)
    finally:
        gccsd._update = upd
    peak_run = torch.cuda.max_memory_allocated()
    if not (q.converged and finite(q.t1, q.t2)):
        raise RuntimeError("(H2O)2 QCISD unconverged")
    # one sweep alone, at the converged amplitudes
    torch.cuda.reset_peak_memory_stats()
    _, s_sweep = seconds(torch, lambda: gccsd._update(
        q.t1, q.t2, q._geris.b, q._geris.fock, q._geris.nocc,
        variant="qcisd"))
    peak_sweep = torch.cuda.max_memory_allocated()
    q._geris = None
    torch.cuda.empty_cache()
    say(11, "(H2O)2/cc-pVTZ qcisd fp32", e_corr=repr(q.e_corr),
        sweeps=nsweep[0], sec_run=f"{s_run:.2f}",
        sec_per_sweep_in_run=f"{s_run / max(nsweep[0], 1):.3f}",
        sec_one_sweep=f"{s_sweep:.3f}", gib_blocks=f"{gib_blocks:.2f}",
        sec_block_build=f"{s_build:.2f}",
        peak_gib_block_build=f"{peak_build / 2**30:.2f}",
        peak_gib_run=f"{peak_run / 2**30:.2f}",
        peak_gib_sweep=f"{peak_sweep / 2**30:.2f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))

    # QCISD(T) through the entry point (engine 'auto': the combine kernel;
    # the call builds the AO ERI on the host and the RERIs on the card)
    (et, s_t), n_t = counted("fused", lambda: seconds(torch, q.ccsd_t), f32)
    nv = nmo - no
    ntrip = -(-nv // 4) * (-(-nv // 4) + 1) * (-(-nv // 4) + 2) // 6
    if not (n_t > 0 and et < 0 and et == et):
        raise RuntimeError(f"(H2O)2 QCISD(T) {et} ({n_t} launches)")
    # the tile loop alone, on the inputs the entry point builds, and its
    # first 16 tiles through each kernel against engine='xla'
    inp = q.triples_inputs()
    del q
    (et_loop, s_loop), n = counted("fused", lambda: seconds(
        torch, lambda: ccsd_t.kernel(*inp, tile=4, vfac=2.0)), f32)
    if not abs(et_loop / et - 1) < RTOL_TILE_FP32:
        raise RuntimeError(f"(H2O)2 QCISD(T) tile loop {et_loop} against "
                           f"the entry point's {et}")
    p, rel = probe(inp, 4, 2.0, "(H2O)2 QCISD(T)")
    del inp
    say(11, "(H2O)2/cc-pVTZ qcisd(t) fp32", e_t=repr(et), tiles=ntrip,
        launches=n_t, sec_entry_point=f"{s_t:.2f}",
        sec_tile_loop=f"{s_loop:.2f}",
        ms_per_tile=f"{s_loop / ntrip * 1e3:.3f}", probe_tiles=NPROBE_SO,
        probe_e=json.dumps({k: v[0] for k, v in p.items()}),
        probe_rel_to_xla=json.dumps({k: f"{v:.2e}" for k, v in rel.items()}),
        probe_ms_per_tile=json.dumps({k: round(v[1] / NPROBE_SO * 1e3, 3)
                                      for k, v in p.items()}))

    # BCCD(T) on the same mean field (all electrons, as the JAX package):
    # bccd.kernel_t's body step by step, so that its first 16 tiles are
    # held against engine='xla' on the inputs the full (T) ran on
    torch.cuda.reset_peak_memory_stats()
    (e_b, mo_b, bt2, nmac), s_b = seconds(torch, lambda: bccd.kernel(
        mf, eri_ao, cc_conv=TOL_FP32["conv_tol"],
        cc_conv_normt=TOL_FP32["conv_tol_normt"], device=dev, dtype=f32))
    inp = bccd.triples_inputs(mf, eri_ao, mo_b, bt2)
    (e_bt, s_bt), n_b = counted("fused", lambda: seconds(
        torch, lambda: ccsd_t.kernel(*inp, tile=bccd.TILE_T)), f32)
    peak_b = torch.cuda.max_memory_allocated()
    if not (n_b > 0 and e_bt < 0 and e_b < 0):
        raise RuntimeError(f"(H2O)2 BCCD(T) {e_b} {e_bt} ({n_b} launches)")
    p, rel = probe(inp, bccd.TILE_T, 1.0, "(H2O)2 BCCD(T)")
    del inp, bt2
    say(11, "(H2O)2/cc-pVTZ bccd(t) fp32", e_bccd=repr(e_b), e_t=repr(e_bt),
        macro_iterations=nmac, launches=n_b, sec_bccd=f"{s_b:.2f}",
        sec_t=f"{s_bt:.2f}", peak_gib=f"{peak_b / 2**30:.2f}",
        probe_tiles=NPROBE_SO,
        probe_e=json.dumps({k: v[0] for k, v in p.items()}),
        probe_rel_to_xla=json.dumps({k: f"{v:.2e}" for k, v in rel.items()}),
        probe_ms_per_tile=json.dumps({k: round(v[1] / NPROBE_SO * 1e3, 3)
                                      for k, v in p.items()}))

    # restricted Lambda-CCSD(T) and make_rdm12 at the frozen-core CCSD
    C = np.asarray(mf.mo_coeff)[:, nfz:]
    er = eris_mod.make_eris_incore(eri_ao, C, mf.get_fock(mf.make_rdm1()),
                                   no, f32, device=dev)
    (c, e_cc, t1, t2), s_cc = seconds(torch, lambda: rccsd.kernel(
        er, **TOL_FP32))
    if not c:
        raise RuntimeError("(H2O)2 CCSD unconverged")
    torch.cuda.reset_peak_memory_stats()
    (_, l1, l2), s_lam = seconds(torch, lambda: ccsd_t_rdm.lambda_kernel(
        t1, t2, er, max_cycle=2, conv_tol=0.0))
    peak_lam = torch.cuda.max_memory_allocated()
    Cd = torch.tensor(C, device=dev, dtype=f64)
    h = (Cd.T @ torch.tensor(mf.get_hcore(), device=dev, dtype=f64)
         @ Cd).to(f32)
    g = ao2mo.full(torch.tensor(eri_ao, device=dev, dtype=f64), Cd).to(f32)
    del er, Cd
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    (d1, d2), s_rdm = seconds(torch, lambda: ccsd_t_rdm.make_rdm12(
        h, g, t1, t2, l1, l2, no))
    peak_rdm = torch.cuda.max_memory_allocated()
    # the Lagrangian is homogeneous of degree one in (h, g) (E(T) too:
    # W Z / D, two degrees over one), so h.d1 + 1/2 g.d2 equals it for any
    # amplitudes and multipliers, and a uniform shift of h leaves all but
    # the HF part unchanged, so tr d1 = 2 nocc; both at fp32 resolution
    dm = torch.zeros(nmo, nmo, device=dev, dtype=f32)
    dm.diagonal()[:no] = 2.0
    lag = float(lambda_ad._lagrangian_of_integrals(
        h, g, dm, t1, t2, l1, l2, no, e_extra=ccsd_t_rdm.e_t_dense))
    e_dm = float((d1 * h).sum() + 0.5 * (g * d2).sum())
    tr1 = float(torch.trace(d1))
    if not (finite(l1, l2, d1, d2) and abs(tr1 - 2 * no) < 1e-3
            and abs(e_dm - lag) < 1e-5 * abs(lag)):
        raise RuntimeError(f"(H2O)2 Lambda(T)/RDMs: tr {tr1}, "
                           f"E(dm) {e_dm} against L {lag}")
    say(11, "(H2O)2/cc-pVTZ lambda(T) and rdm fp32", e_ccsd=repr(float(e_cc)),
        sec_ccsd=f"{s_cc:.2f}", sec_per_lambda_cycle=f"{s_lam / 2:.3f}",
        peak_gib_lambda=f"{peak_lam / 2**30:.2f}", sec_rdm=f"{s_rdm:.3f}",
        peak_gib_rdm=f"{peak_rdm / 2**30:.2f}",
        trace_rdm1=f"{tr1:.6f}", e_dm=repr(e_dm), lagrangian=repr(lag),
        cube_gib=f"{(nmo - no) ** 3 * no ** 3 * 4 / 2**30:.2f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    del t1, t2, l1, l2, d1, d2, h, g, dm
    torch.cuda.empty_cache()

    # DF-GMP2 on the DF mean field, fp32 against fp64
    e_df = {}
    for dt in (f32, f64):
        (e_df[dt], _), s = seconds(torch, lambda: dfgmp2.DFGMP2(
            mf, frozen=nfz, device=dev, dtype=dt).kernel())
    if not abs(e_df[f32] - e_df[f64]) < ATOL_MAIN_FP32:
        raise RuntimeError(f"(H2O)2 DF-GMP2 fp32 vs fp64: {e_df}")
    say(11, "(H2O)2/cc-pVTZ df-gmp2", e_corr_fp32=repr(e_df[f32]),
        e_corr_fp64=repr(e_df[f64]),
        diff=f"{abs(e_df[f32] - e_df[f64]):.2e}", sec_fp64=f"{s:.3f}")
    return {"fp32": launches[f32], "fp64": launches[f64]}


def eom_stream_phase(torch, smi, dev, sweep_sec):
    """Phase 12: EOM-CCSD, MOM-GF-CCSD and the host-streamed Lvv on the
    card (no hand kernel on these paths).  (a) fp64 pins: H2O/cc-pVDZ IP,
    EA and EE through the driver methods (tight, and at their defaults),
    H2/6-31g EE against the exact singlet spectrum, the U IP/EA of
    OH/sto-3g against the host eom_slow oracle, eomsf_ccsd and the
    restricted triplet against the U EE root of H2O/sto-3g, MOM-GF poles
    against Davidson IP/EA; (b) the H2O/cc-pVDZ roots in fp32 against
    fp64; (c) benzene/cc-pVDZ through examples/eom_benzene.run in fp32
    against the reference's pins; (d) one EE sigma at the (H2O)8 shape;
    (e) the streamed ladder at the (H2O)8 shape against the resident one:
    one sweep and one Lambda step, peaks, bytes moved and the host ->
    device rate.  sweep_sec: phase 4's sweep, the unit of (d)."""
    import numpy as np

    from pyscf_mpcc_tpu_torch import ao2mo, gto, testing
    from pyscf_mpcc_tpu_torch import scf as pscf
    from pyscf_mpcc_tpu_torch.cc import (eom, eom_slow, gccsd_slow,
                                         lambda_ad, rccsd)
    from pyscf_mpcc_tpu_torch.cc.driver import CCSD
    from pyscf_mpcc_tpu_torch.cc.momgfccsd import (MomGFCCSD,
                                                   build_hole_moments)
    from pyscf_mpcc_tpu_torch.examples import eom_benzene
    from pyscf_mpcc_tpu_torch.lib import memory
    from pyscf_mpcc_tpu_torch.lib.hoststore import HostStore

    f64, f32 = torch.float64, torch.float32
    tight = dict(conv_tol=1e-11, conv_tol_normt=1e-9, max_cycle=100)

    def rhf(atom, basis, **kw):
        mf = pscf.RHF(gto.M(atom=atom, basis=basis, **kw))
        mf.conv_tol, mf.conv_tol_grad = 1e-13, 1e-10
        return mf.run()

    def check(name, got, want, atol):
        err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
        if not err < atol:
            raise RuntimeError(f"{name}: {got} against {want}, |d| {err} "
                               f"(limit {atol})")
        return err

    # (a) H2O/cc-pVDZ pins through the driver methods, fp64 on the card
    t0 = time.perf_counter()
    mf = rhf(EOM_H2O, "cc-pvdz", unit="angstrom")
    roots, errs = {}, {}
    for dt in (f64, f32):
        cc = CCSD(mf, device=dev, dtype=dt).set(
            **(tight if dt == f64 else EOM_FP32_CCSD))
        cc.run()
        if not cc.converged:
            raise RuntimeError(f"H2O/cc-pVDZ CCSD ({dt}) did not converge")
        tol = 1e-9 if dt == f64 else EOM_FP32_TOL
        roots[dt] = {"ip": cc.ipccsd(nroots=3, tol=tol),
                     "ea": cc.eaccsd(nroots=3, tol=tol),
                     "ee": cc.eeccsd(nroots=3, tol=tol)}
        if dt == f64:
            errs["e_corr"] = check("E_corr", cc.e_corr, EOM_PINS["e_corr"],
                                   1e-8)
            for k, lim in (("ip", 1e-7), ("ea", 1e-7), ("ee", 5e-7)):
                errs[k] = check(f"{k} pins", roots[dt][k], EOM_PINS[k], lim)
            # the driver methods at their defaults, same amplitudes
            dflt = {"ip": cc.ipccsd(), "ea": cc.eaccsd(), "ee": cc.eeccsd()}
            d_dflt = max(check(f"{k} at defaults", v, roots[dt][k],
                               ATOL_EOM_DEFAULTS) for k, v in dflt.items())
        del cc
    say(12, "h2o/cc-pvdz eom pins fp64 ok", dtype="float64",
        ip=json.dumps(list(roots[f64]["ip"])),
        ea=json.dumps(list(roots[f64]["ea"])),
        ee=json.dumps(list(roots[f64]["ee"])),
        errs=json.dumps({k: f"{v:.2e}" for k, v in errs.items()}),
        atol="ip/ea 1e-7, ee 5e-7", defaults_max_d=f"{d_dflt:.2e}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    # (b) fp32 against fp64, the same roots
    gap = max(check(f"{k} fp32 vs fp64", roots[f32][k], roots[f64][k],
                    ATOL_EOM_FP32) for k in ("ip", "ea", "ee"))
    say(12, "h2o/cc-pvdz eom fp32 vs fp64 ok", worst_gap=f"{gap:.2e}",
        atol=ATOL_EOM_FP32, davidson_tol_fp32=EOM_FP32_TOL)

    # H2/6-31g: CCSD is FCI, the EE roots are the exact singlet gaps
    t0 = time.perf_counter()
    mf = rhf("H 0 0 0; H 0 0 0.74", "6-31g")
    cc = CCSD(mf, device=dev, dtype=f64).set(conv_tol=1e-12,
                                            conv_tol_normt=1e-11).run()
    mo = np.asarray(mf.mo_coeff)
    h = mo.T @ mf.get_hcore() @ mo
    g = ao2mo.full(torch.tensor(gto.intor_eri(mf.mol)),
                   torch.tensor(mo)).numpy()
    pairs = [(p, q) for p in range(len(h)) for q in range(p, len(h))]

    def me(p, q, r, s):
        return h[p, r] * (q == s) + h[q, s] * (p == r) + g[p, r, q, s]

    H = np.array([[0.5 * (me(p, q, r, s) + me(p, q, s, r) + me(q, p, r, s)
                          + me(q, p, s, r))
                   / ((np.sqrt(2.0) if p == q else 1.0)
                      * (np.sqrt(2.0) if r == s else 1.0))
                   for r, s in pairs] for p, q in pairs])
    fci = np.linalg.eigvalsh(H)
    e_ee = cc.eeccsd(nroots=2, tol=1e-7)
    d_h2 = check("H2 EE vs FCI", e_ee, fci[1:3] - fci[0], 1e-6)
    # OH/sto-3g: U IP/EA per spin against the host eom_slow oracle
    umf = pscf.UHF(gto.M(atom="O 0 0 0; H 0 0 0.97", basis="sto-3g",
                         spin=1))
    umf.conv_tol, umf.conv_tol_grad = 1e-13, 1e-10
    umf.kernel()
    so = gccsd_slow.eris_from_scf(umf)
    e_so, T1, T2, conv = gccsd_slow.kernel(so, conv_tol=1e-12,
                                           conv_tol_normt=1e-11,
                                           max_cycle=200)
    h_so = eom_slow.h_so_from_eris(so)
    e_cc = float(umf.e_tot - umf.mol.energy_nuc() + e_so)
    ucc = CCSD(umf, device=dev, dtype=f64).set(conv_tol=1e-12,
                                              conv_tol_normt=1e-10,
                                              max_cycle=200).run()
    if not (conv and ucc.converged):
        raise RuntimeError("OH/sto-3g GCCSD or UCCSD did not converge")
    na, _ = umf.mol.nelec
    d_u = 0.0
    for spin, n_ip, n_ea in (("a", na - 1, na + 1), ("b", na, na)):
        kw = dict(nroots=2, e_ccsd_tot=e_cc, spins=so.spins)
        ref_ip = eom_slow.ipccsd(h_so, so.ints, T1, T2, so.nocc, so.nso,
                                 nalpha=n_ip, **kw)[:2]
        ref_ea = eom_slow.eaccsd(h_so, so.ints, T1, T2, so.nocc, so.nso,
                                 nalpha=n_ea, **kw)[:2]
        d_u = max(d_u, check(f"U IP {spin}", ucc.ipccsd(nroots=2, tol=1e-9,
                                                         spin=spin),
                             ref_ip, 1e-8),
                  check(f"U EA {spin}", ucc.eaccsd(nroots=2, tol=1e-9,
                                                   spin=spin), ref_ea, 1e-8))
    # H2O/sto-3g: the spin-flip root (Ms = -1) and the restricted triplet
    # are the lowest (Ms = 0 triplet) root of the spin-blocked U EE
    mf = rhf(EOM_H2O, "sto-3g", unit="angstrom")
    cc = CCSD(mf, device=dev, dtype=f64).set(**tight).run()
    e_sf = cc.eomsf_ccsd(nroots=1, tol=1e-7)
    ucc = CCSD(pscf.convert_to_uhf(mf), device=dev, dtype=f64).set(
        **tight).run()
    _, e_u, _ = eom.kernel_ee_u(ucc.t1, ucc.t2, ucc.eris, nroots=2,
                                tol=1e-7)
    _, e_trip, _ = eom.kernel_ee_triplet(cc.t1, cc.t2, ucc.eris, nroots=1,
                                         tol=1e-8)
    d_sf = check("SF vs U triplet", e_sf[0], e_u[0], 5e-6)
    d_trip = check("triplet vs U", e_trip[0], e_u[0], 1e-7)
    # MOM-GF: hole and particle poles against Davidson IP/EA
    cc.solve_lambda()
    gf = MomGFCCSD(cc, niter=(4, 4))
    gf.kernel()
    ips, w_ip = gf.ipgfccsd(nroots=3)
    eas, _ = gf.eagfccsd(nroots=3)
    d_gf = max(check("MOM-GF IP", ips[0], cc.ipccsd(nroots=1)[0], 2e-3),
               check("MOM-GF EA", eas[0], cc.eaccsd(nroots=1)[0], 2e-3))
    if not w_ip[0] > 0.5:
        raise RuntimeError(f"MOM-GF first hole pole weight {w_ip[0]}")
    mom = build_hole_moments(cc.t1, cc.t2, cc.l1, cc.l2, cc.eris, 2)
    gf2 = MomGFCCSD(cc, niter=(2, 2))
    gf2.kernel(hole_moments=mom)
    d_mom = max(gf2.moment_errors(mom, gf2.eh, gf2.vh))
    if not d_mom < 1e-6:
        raise RuntimeError(f"MOM-GF moments not conserved: {d_mom}")
    say(12, "small eom checks fp64 ok", h2_ee_vs_fci=f"{d_h2:.2e}",
        oh_u_ip_ea_vs_oracle=f"{d_u:.2e}", sf_vs_u_triplet=f"{d_sf:.2e}",
        triplet_vs_u=f"{d_trip:.2e}", momgf_vs_davidson=f"{d_gf:.2e}",
        momgf_moment_err=f"{d_mom:.2e}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    del cc, ucc, gf, gf2

    # (c) benzene/cc-pVDZ, fp32, the JAX example's tolerances
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bz = eom_benzene.run(dev, f32, ee_roots=BENZENE_EE_ROOTS)
    for k in ("ee", "ip", "ea"):
        r = bz[k]
        if not (r["converged"] and r["max_abs_dev_ev"] < ATOL_BENZENE_EV):
            raise RuntimeError(f"benzene {k}: {r}")
        say(12, f"benzene {k} fp32 ok", roots_ev=json.dumps(
            [round(x, 6) for x in r["roots_ev"]]),
            max_abs_dev_ev=f"{r['max_abs_dev_ev']:.2e}",
            atol_ev=ATOL_BENZENE_EV, cycles=r["cycles"],
            matvecs=r["matvecs"], s_per_sigma=f"{r['s_per_sigma']:.4f}",
            sec=f"{r['sec']:.1f}",
            davidson_sec=f"{r['davidson_sec']:.1f}",
            peak_gib=r["peak_gib"])
    say(12, "benzene set-up", card=json.dumps(smi),
        e_scf=repr(bz["e_scf"]), d_scf=f"{bz['d_scf_vs_ref']:.2e}",
        e_corr=repr(bz["e_corr"]), d_ccsd=f"{bz['d_ccsd_vs_ref']:.2e}",
        host_rhf_s=f"{bz['rhf_s']:.1f}", host_eri_s=f"{bz['eri_s']:.1f}",
        device_eris_s=f"{bz['eris_s']:.2f}", ccsd_s=f"{bz['ccsd_s']:.1f}",
        fp64="left out (the script's budget)",
        seconds=f"{time.perf_counter() - t0:.1f}")

    # (d) one EE sigma at the (H2O)8 shape (cold: the call's first run)
    gen = torch.Generator(device=dev).manual_seed(0)
    beris = testing.synthetic_eris(NOCC, NVIR, NAUX, device=dev, dtype=f32,
                                   generator=gen, build_ovvv=False)
    _, bt1, bt2 = rccsd.init_amps(beris)
    ntile_eom = eom.plan_ntile(beris)
    r1 = torch.randn(bt1.shape, generator=gen, device=dev) * 1e-2
    r2 = torch.randn(bt2.shape, generator=gen, device=dev) * 1e-2
    r2 = 0.5 * (r2 + r2.permute(1, 0, 3, 2))
    torch.cuda.reset_peak_memory_stats()
    (s1, s2), sec_sig = seconds(torch, lambda: eom.ee_sigma(
        bt1, bt2, beris, r1, r2, ntile=ntile_eom))
    peak_sig = torch.cuda.max_memory_allocated()
    if not (torch.isfinite(s1).all() and torch.isfinite(s2).all()):
        raise RuntimeError("non-finite EE sigma at the (H2O)8 shape")
    del s1, s2, r1, r2
    say(12, "(H2O)8 ee sigma fp32", ntile=ntile_eom,
        ntile_sweep_planner=memory.plan_ladder_ntile(NOCC, NVIR, NAUX, f32,
                                                     device=dev),
        sec=f"{sec_sig:.3f}", sweeps=f"{sec_sig / sweep_sec:.2f}",
        peak_gib=f"{peak_sig / 2**30:.2f}",
        vector_gb_fp64=f"{8 * (bt1.numel() + bt2.numel()) / 1e9:.2f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))

    # (e) the streamed ladder at the (H2O)8 shape, ntile NTILE_STREAM:
    # resident first, its results kept on the host, then Lvv moves to a
    # pinned host store and leaves the device.  The MP2 guess has t1 = 0
    # here (a diagonal Fock), which would make every t1 term an exact
    # zero: a seeded t1 of 1e-2 dresses the tiles
    nt = NTILE_STREAM
    et1 = 1e-2 * torch.randn(bt1.shape, generator=gen, device=dev,
                             dtype=f32)

    def sweep(er):
        torch.cuda.reset_peak_memory_stats()
        rccsd.update_amps(et1, bt2, er, ntile=nt)       # warm
        (a1, a2), s = seconds(torch, lambda: rccsd.update_amps(
            et1, bt2, er, ntile=nt))
        peak = torch.cuda.max_memory_allocated()
        a2 = a2.cpu()
        del a1
        torch.cuda.reset_peak_memory_stats()
        out, s_l = seconds(torch, lambda: lambda_ad._lambda_step(
            et1, bt2, et1, bt2, er, ntile=nt))
        peak_l = torch.cuda.max_memory_allocated()
        res2 = out[3].cpu()
        del out
        return a2, s, peak, res2, s_l, peak_l

    res = sweep(beris)
    lvv_bytes = beris.Lvv.numel() * beris.Lvv.element_size()
    store = HostStore.from_tensor(beris.Lvv, dev, ntile=nt)
    beris = beris._replace(Lvv=None, Lvv_stream=store)
    torch.cuda.empty_cache()
    tile_bytes = store.nbytes // store.ntile
    b0 = store.bytes_moved
    strm = sweep(beris)
    moved = store.bytes_moved - b0
    # two sweeps (warm and timed) and one Lambda step moved `moved`; the
    # sweep's share is one third only if the three move alike: count one
    # sweep apart
    b1 = store.bytes_moved
    rccsd.update_amps(et1, bt2, beris, ntile=nt)
    torch.cuda.synchronize()
    moved_sweep = store.bytes_moved - b1
    # the host -> device rate on the same pinned buffer, all tiles
    tiles = [store.tiles[a] for a in range(store.ntile)]
    _, s_copy = seconds(torch, lambda: [t.to(dev, non_blocking=True)
                                        for t in tiles])
    rate = store.nbytes / s_copy
    rel = float((strm[0] - res[0]).norm() / res[0].norm())
    rel_l = float((strm[3] - res[3]).norm() / res[3].norm())
    saved = res[2] - strm[2], res[5] - strm[5]
    need = lvv_bytes - 3 * tile_bytes
    copy_s = moved_sweep / rate
    if not (rel < RTOL_STREAM and rel_l < RTOL_STREAM
            and min(saved) >= need):
        raise RuntimeError(
            f"streamed vs resident: sweep rel {rel}, Lambda rel {rel_l}; "
            f"peaks saved {saved} bytes, need {need}")
    say(12, "(H2O)8 streamed ladder fp32 ok", ntile=nt, rtol=RTOL_STREAM,
        rel_sweep=f"{rel:.2e}", rel_lambda_res2=f"{rel_l:.2e}",
        lvv_gib=f"{lvv_bytes / 2**30:.3f}",
        tile_gib=f"{tile_bytes / 2**30:.4f}",
        sweep_sec_resident=f"{res[1]:.3f}", sweep_sec_streamed=f"{strm[1]:.3f}",
        peak_gib_resident=f"{res[2] / 2**30:.2f}",
        peak_gib_streamed=f"{strm[2] / 2**30:.2f}",
        lambda_sec_resident=f"{res[4]:.3f}",
        lambda_sec_streamed=f"{strm[4]:.3f}",
        lambda_peak_gib_resident=f"{res[5] / 2**30:.2f}",
        lambda_peak_gib_streamed=f"{strm[5] / 2**30:.2f}",
        saved_gib=json.dumps([round(x / 2**30, 3) for x in saved]),
        need_gib=f"{need / 2**30:.3f}",
        h2d_gb_per_sweep=f"{moved_sweep / 1e9:.3f}",
        h2d_gb_all=f"{moved / 1e9:.3f}", h2d_gb_per_s=f"{rate / 1e9:.2f}",
        copy_sec_per_sweep=f"{copy_s:.3f}",
        unhidden_sec=f"{strm[1] - res[1]:.3f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    del beris, bt1, bt2, et1, store, tiles


def _free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def run_ranks(fn, world, *args):
    """fn(rank, world, init_method, *args) on ``world`` ranks: rank 0 in
    this process, the others in processes of the 'spawn' start method.
    Returns rank 0's result.  A spawned rank that fails or outlives
    RANK_TIMEOUT fails the phase (it is killed); when rank 0 raises, the
    others are killed at once."""
    import multiprocessing as mp
    init = f"tcp://localhost:{_free_port()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=(r, world, init, *args))
             for r in range(1, world)]
    for p in procs:
        p.start()
    try:
        out = fn(0, world, init, *args)
    except BaseException:
        for p in procs:
            p.kill()
            p.join()
        raise
    deadline = time.monotonic() + RANK_TIMEOUT
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()
    bad = [(r + 1, p.exitcode) for r, p in enumerate(procs)
           if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"spawned ranks failed (rank, exit code): {bad}")
    return out


def _rel(torch, a, b):
    return float(torch.linalg.norm(a.double() - b.double())
                 / torch.linalg.norm(b.double()))


def mesh_bench(rank, world, init_method):
    """Phase 13(a) on one rank of a NCCL group over the visible cards: the
    sharded and tiled sweeps and the mesh (T) probes at the (H2O)8 shape,
    the mesh UCCSD(T) probe at the OH(H2O)3/cc-pVTZ shape.  Rank 0 holds
    each to the same call without a mesh, prints, and returns the mesh
    probes' launches {'fused', 'chunk', 'resident'}."""
    import torch
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from pyscf_mpcc_tpu_torch import testing
    from pyscf_mpcc_tpu_torch.cc import ccsd_t, rccsd, uccsd, uccsd_t
    from pyscf_mpcc_tpu_torch.lib import memory
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    from pyscf_mpcc_tpu_torch.parallel import ccsd_shard as cs
    from pyscf_mpcc_tpu_torch.parallel import distributed
    from pyscf_mpcc_tpu_torch.parallel import mesh as pm
    f32 = torch.float32
    root = rank == 0
    distributed.initialize(init_method, world_size=world, rank=rank,
                           device=torch.device("cuda", rank))
    try:
        mesh = pm.make_mesh()
        dev = mesh.device
        # the communicator is made at the first collective: before timing
        mesh.psum(torch.ones(1, device=dev))
        if root:
            say(13, "mesh", backend=mesh.backend, world_size=mesh.size,
                device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        er = testing.synthetic_eris(NOCC, NVIR, NAUX, device=dev, dtype=f32,
                                    generator=gen, build_ovvv=False)
        _, t1_mp2, t2 = rccsd.init_amps(er)
        # the MP2 guess has t1 = 0 (a diagonal Fock): the sweeps take a
        # seeded one, the (T) probes phase 4's amplitudes
        t1 = 1e-2 * torch.randn(t1_mp2.shape, generator=gen, device=dev,
                                dtype=f32)
        ntile = memory.plan_ladder_ntile(NOCC, NVIR, NAUX, f32, device=dev)
        ref2 = None
        if root:
            rccsd.update_amps(t1, t2, er, ntile=ntile)     # warm-up
            torch.cuda.reset_peak_memory_stats(dev)
            (_, ref2), s_ref = seconds(torch, lambda: rccsd.update_amps(
                t1, t2, er, ntile=ntile))
            peak_ref = torch.cuda.max_memory_allocated(dev)
        sweeps = {}
        runs = (("sharded", pm.shard_eris, pm.shard_amps,
                 lambda a, b, e: pm.sharded_update_amps(mesh, ntile)(a, b,
                                                                     e)),
                ("tiled", cs.shard_eris_tiled, cs.shard_amps_tiled,
                 lambda a, b, e: cs.update_amps_tiled(a, b, e, mesh,
                                                      ntile=ntile,
                                                      nchunk=2)))
        for name, put_eris, put_amps, sweep in runs:
            es = put_eris(er, mesh)
            a1, a2 = put_amps(t1, t2, mesh)
            torch.cuda.reset_peak_memory_stats(dev)
            (o1, o2), sec = seconds(torch, lambda: sweep(a1, a2, es))
            peak = torch.cuda.max_memory_allocated(dev)
            o2 = mesh.all_gather(o2)
            if root:
                rel = _rel(torch, o2, ref2)
                if not (rel < RTOL_SWEEP_FP32
                        and torch.isfinite(o1).all()):
                    raise RuntimeError(f"{name} sweep deviates from "
                                       f"rccsd.update_amps by {rel}")
                sweeps[name] = dict(sec=f"{sec:.4f}",
                                    peak_gib=f"{peak / 2**30:.2f}",
                                    rel_t2=f"{rel:.3e}")
            del es, a1, a2, o1, o2
        if root:
            say(13, "(H2O)8 sweeps fp32", ntile=ntile, nchunk_tiled=2,
                sec_unsharded=f"{s_ref:.4f}",
                peak_gib_unsharded=f"{peak_ref / 2**30:.2f}",
                sweeps=json.dumps(sweeps), rtol=RTOL_SWEEP_FP32,
                clocks_after=json.dumps(nvidia_smi(CLOCKS)))
        del ref2

        def probe(mod, kern, call, **kw):
            """(E, ms a tile, launches of the mesh run) of the 64-tile
            probe through kern.kernel (its _tile_triples cut as in phase
            4), and on rank 0 the same without a mesh: (E, s).  mod: the
            kernel module whose launches are counted (None: no kernel)."""
            orig = kern._tile_triples
            kern._tile_triples = lambda nvt: orig(nvt)[:NPROBE]
            try:
                single = None
                if root:
                    call(**kw)                            # warm-up
                    single = seconds(torch, lambda: call(**kw))
                call(mesh=mesh, **kw)                     # warm-up
                if mod is not None:
                    mod.launch_count = 0
                e, sec = seconds(torch, lambda: call(mesh=mesh, **kw))
                n = None if mod is None else mod.launch_count
            finally:
                kern._tile_triples = orig
            if root and not abs(e - single[0]) <= RTOL_TILE_FP32 * abs(
                    single[0]):
                raise RuntimeError(f"mesh (T) probe {e!r} against "
                                   f"{single[0]!r} ({kw})")
            return e, sec / NPROBE * 1e3, n, single

        def rtrip(**kw):
            return ccsd_t.kernel(t1_mp2, t2, er, tile=TILE, **kw)

        launches, rows = {}, {}
        for name, mod, kw in (
                ("fused", tc, dict(engine="fused")),
                ("chunk", tc, dict(engine="fused", chunk=4)),
                ("resident", tr, dict(engine="resident",
                                      dot_precision="high"))):
            e, ms, n, single = probe(mod, ccsd_t, rtrip, **kw)
            if root and n == 0:
                raise RuntimeError(f"the mesh probe {name} launched no "
                                   "kernel")
            launches[name] = n
            if root:
                rows[name] = dict(launches=n, ms_per_tile=f"{ms:.3f}",
                                  ms_per_tile_unsharded=(
                                      f"{single[1] / NPROBE * 1e3:.3f}"),
                                  e=repr(e), e_unsharded=repr(single[0]))
        if root:
            say(13, "(T) probe through the mesh fp32", tiles=NPROBE,
                engines=json.dumps(rows),
                clocks_after=json.dumps(nvidia_smi(CLOCKS)))
        del er, t1, t1_mp2, t2
        torch.cuda.empty_cache()

        na, nb, va, vb, naux = OS_SHAPE
        ue = testing.synthetic_ueris(na, nb, va, vb, naux, device=dev,
                                     dtype=f32, seed=0)
        _, u1, u2 = uccsd.init_amps(ue)

        def utrip(**kw):
            return uccsd_t.kernel(u1, u2, ue, tile=TILE, **kw)

        e, ms, _, single = probe(None, uccsd_t, utrip)
        if root:
            say(13, "OH(H2O)3/cc-pVTZ-shape UCCSD(T) probe through the mesh "
                "fp32", tiles=NPROBE, ms_per_tile=f"{ms:.3f}",
                ms_per_tile_unsharded=f"{single[1] / NPROBE * 1e3:.3f}",
                e=repr(e), e_unsharded=repr(single[0]))
        del ue, u1, u2
        torch.cuda.empty_cache()
        return launches
    finally:
        dist.destroy_process_group()


def shared_card(rank, world, init_method):
    """Phase 13(b) on one rank: the ranks share card 0 over gloo, fp64.
    The JAX package's four dry-run stages (__graft_entry__'s
    _dryrun_multichip_impl at nocc 8, nvir 16, naux 8 a rank) and a mesh
    (T) of 35 tiles through the combine kernel, each against the same
    call on one rank (every rank runs it), which rank 0 returns with the
    gaps: {stage: max abs gap}, and its fp64 launches."""
    import torch
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from pyscf_mpcc_tpu_torch import testing
    from pyscf_mpcc_tpu_torch.cc import ccsd_t, rccsd, uccsd
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    from pyscf_mpcc_tpu_torch.parallel import ccsd_shard as cs
    from pyscf_mpcc_tpu_torch.parallel import distributed
    from pyscf_mpcc_tpu_torch.parallel import mesh as pm
    f64 = torch.float64
    dev = torch.device("cuda", 0)
    distributed.initialize(init_method, world_size=world, rank=rank,
                           device=dev, backend="gloo")
    try:
        mesh = pm.make_mesh(device=dev)
        nocc, nvir, naux = 8, 16, 8 * world
        gen = torch.Generator(device=dev).manual_seed(0)
        gaps = {}

        def gap(a, b):
            return max(float((x - y).abs().max()) for x, y in zip(a, b))

        def seeded_t1(t1):
            return 1e-2 * torch.randn(t1.shape, generator=gen, device=dev,
                                      dtype=f64)

        n0 = (tc.launch_count, tr.launch_count)
        # stage 1: sharded RCCSD update (DF factors and ovvv)
        er = testing.synthetic_eris(nocc, nvir, naux, device=dev, dtype=f64,
                                    generator=gen)
        _, t1, t2 = rccsd.init_amps(er)
        t1 = seeded_t1(t1)
        o1, o2 = pm.sharded_update_amps(mesh)(
            *pm.shard_amps(t1, t2, mesh), pm.shard_eris(er, mesh))
        gaps["1 sharded update"] = gap(
            (o1, mesh.all_gather(o2)), rccsd.update_amps(t1, t2, er))
        # stage 2: the sharded (T) tile scan (tile 4, 20 tiles)
        ed = testing.synthetic_eris(nocc, nvir, naux, device=dev, dtype=f64,
                                    generator=gen, build_ovvv=False)
        _, d1, d2 = rccsd.init_amps(ed)
        d1 = seeded_t1(d1)
        for eng in ("fused", "resident"):
            gaps[f"2 (T) {eng}"] = abs(
                ccsd_t.kernel(d1, d2, ed, tile=4, engine=eng, mesh=mesh)
                - ccsd_t.kernel(d1, d2, ed, tile=4, engine=eng))
        # stage 3: sharded UCCSD update
        ue = testing.synthetic_ueris(nocc, nocc, 12, 12, naux, device=dev,
                                     dtype=f64, seed=1)
        _, u1, u2 = uccsd.init_amps(ue)
        u1 = tuple(seeded_t1(x) for x in u1)
        s1, s2 = pm.sharded_uccsd_update(mesh)(
            *pm.shard_uamps(u1, u2, mesh), pm.shard_ueris(ue, mesh))
        r1, r2 = uccsd.update_amps(u1, u2, ue, ntile=1)
        gaps["3 sharded uccsd update"] = gap(
            (*s1, *(mesh.all_gather(x) for x in s2)), (*r1, *r2))
        # stage 4: the tiled update (sharded compute)
        p1, p2 = cs.update_amps_tiled(
            *cs.shard_amps_tiled(d1, d2, mesh), cs.shard_eris_tiled(ed, mesh),
            mesh, ntile=2, nchunk=2)
        gaps["4 tiled update"] = gap(
            (p1, mesh.all_gather(p2)), rccsd.update_amps(d1, d2, ed,
                                                         ntile=2))
        # the mesh (T) with the tile list split unevenly (35 tiles)
        t1r, t2r, fr = testing.triples_tensors(
            *testing.random_triples_problem(4, 9, 5, naux=13), dev, f64)
        gaps["(T) 35 tiles fused"] = abs(
            ccsd_t.kernel(t1r, t2r, fr, tile=2, engine="fused", mesh=mesh)
            - ccsd_t.kernel(t1r, t2r, fr, tile=2, engine="fused"))
        n = dict(fused=tc.launch_count - n0[0],
                 resident=tr.launch_count - n0[1])
        return gaps, n, mesh.backend
    finally:
        dist.destroy_process_group()


def bf16_tier_phase(torch, smi, dev):
    """Phase 14: the (T) bf16 tiers (dot_precision 'high' and 'default')
    on the fused engine, whose W1 dots are one bf16 GEMM with fp32 output
    each (torch.mm(..., out_dtype=torch.float32), K tripled for 'high')
    feeding the combine kernel.  (a) The bench shape (phase 1's synthetic
    integrals): the 64-tile probe through ccsd_t.kernel, fused at 'high'
    and 'default' against the resident engine in modes split (through
    engine='auto') and bf16 and against the fused engine at full
    precision, three timed runs each, and fused 'high' at chunk 4; one
    tile's six W1 GEMMs per tier and their operand split.  (b) The
    (H2O)12/cc-pVTZ frozen-core shape, past the resident kernel's cap:
    the 16-tile probe, fused 'high' and 'default' against fused full
    precision and, on 2 tiles, against engine='xla' at the same tier, and
    engine='auto' at 'high' there (the fused engine, the combine kernel's
    count grows, the resident one's does not).  Returns the combine
    kernel's launches in the timed probe runs, {"fused": chunk-1 runs,
    "chunk": chunk-4 runs}; the 2-tile comparisons are counted apart."""
    from pyscf_mpcc_tpu_torch import testing
    from pyscf_mpcc_tpu_torch.cc import ccsd_t, rccsd
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    f32 = torch.float32
    launches = {"fused": 0, "chunk": 0}

    # the overload the bf16 GEMMs run on; no fallback if it is missing
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.rand((64, 48), generator=g, device=dev).to(torch.bfloat16)
    b = torch.rand((48, 80), generator=g, device=dev).to(torch.bfloat16)
    c = torch.mm(a, b, out_dtype=torch.float32)
    torch.testing.assert_close(c, a.float() @ b.float(), rtol=1e-5,
                               atol=1e-5)
    say(14, "torch.mm(bf16, bf16, out_dtype=float32) ok",
        torch=torch.__version__, out_dtype=str(c.dtype))

    def probe(t1, t2, er, ntiles, engine, reps=3, record=None, **kw):
        """E(T) over the first ntiles tiles through ccsd_t.kernel after a
        warm-up; reps timed runs, each with both kernels' counts zeroed
        just before and read just after.  Returns (energy of the first
        run, [ms a tile], combine launches, resident launches) of the
        timed runs; the runs must agree to RTOL_TIER."""
        orig = ccsd_t._tile_triples
        ccsd_t._tile_triples = lambda nvt: orig(nvt)[:ntiles]
        ms, ncomb, nres, es = [], 0, 0, []
        try:
            ccsd_t.kernel(t1, t2, er, tile=TILE, engine=engine, **kw)
            torch.cuda.synchronize()
            for _ in range(reps):
                tc.launch_count = tr.launch_count = 0
                t0 = time.perf_counter()
                es.append(ccsd_t.kernel(t1, t2, er, tile=TILE,
                                        engine=engine, **kw))
                ms.append((time.perf_counter() - t0) / ntiles * 1e3)
                ncomb += tc.launch_count
                nres += tr.launch_count
        finally:
            ccsd_t._tile_triples = orig
        e = es[0]
        if not (e == e and abs(e) < float("inf")
                and all(abs(x - e) <= RTOL_TIER * abs(e) for x in es)):
            raise RuntimeError(f"(T) probe {engine} {kw}: energies {es}")
        if record is not None:
            launches[record] += ncomb
        return e, ms, ncomb, nres

    def rel(x, y):
        return abs(x - y) / abs(y)

    def fmt(ms):
        return " ".join(f"{t:.3f}" for t in ms)

    # ---- (a) the bench shape ---------------------------------------------
    t0_ = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    er = testing.synthetic_eris(NOCC, NVIR, NAUX, device=dev, dtype=f32,
                                generator=gen, build_ovvv=False)
    er = er._replace(oovv=None, ovvo=None)
    _, t1, t2 = rccsd.init_amps(er)
    if ccsd_t.auto_engine("cuda", NOCC, f32, "split") != "resident":
        raise RuntimeError("auto does not take 'high' to the resident "
                           f"kernel at nocc {NOCC}")
    res = {}
    for name, engine, kw, rec in (
            ("fused", "fused", {}, "fused"),
            ("fused_high", "fused", dict(dot_precision="high"), "fused"),
            ("fused_default", "fused", dict(dot_precision="default"),
             "fused"),
            ("auto_high", "auto", dict(dot_precision="high"), None),
            ("resident_default", "resident", dict(dot_precision="default"),
             None),
            ("fused_high_chunk4", "fused", dict(dot_precision="high",
                                                chunk=4), "chunk")):
        res[name] = probe(t1, t2, er, NPROBE, engine, record=rec, **kw)
    if not (res["auto_high"][3] > 0 and res["auto_high"][2] == 0):
        raise RuntimeError(f"auto at 'high', nocc {NOCC}: launches "
                           f"{res['auto_high'][2:]}, not the resident")
    e_full = res["fused"][0]
    gaps = {"high_vs_split": rel(res["fused_high"][0], res["auto_high"][0]),
            "default_vs_bf16": rel(res["fused_default"][0],
                                   res["resident_default"][0]),
            "high_chunk4_vs_high": rel(res["fused_high_chunk4"][0],
                                       res["fused_high"][0]),
            "high_vs_full": rel(res["fused_high"][0], e_full),
            "default_vs_full": rel(res["fused_default"][0], e_full),
            "split_vs_full": rel(res["auto_high"][0], e_full)}
    if not (max(gaps["high_vs_split"], gaps["default_vs_bf16"],
                gaps["high_chunk4_vs_high"]) <= RTOL_TIER
            and gaps["high_vs_full"] <= RTOL_SPLIT
            and min(res[k][2] for k in ("fused", "fused_high",
                                        "fused_default",
                                        "fused_high_chunk4")) > 0):
        raise RuntimeError(f"bf16 tiers at the bench shape: {gaps} "
                           f"{ {k: v[0] for k, v in res.items()} }")
    say(14, "(a) bench-shape probe ok", shape=f"o={NOCC},T={TILE},"
        f"nvir={NVIR}", tiles=NPROBE,
        ms_per_tile=json.dumps({k: fmt(v[1]) for k, v in res.items()}),
        energies=json.dumps({k: repr(v[0]) for k, v in res.items()}),
        gaps=json.dumps({k: f"{v:.3e}" for k, v in gaps.items()}),
        rtol_tier=RTOL_TIER, rtol_high_vs_full=RTOL_SPLIT,
        launches=json.dumps({k: v[2:] for k, v in res.items()}),
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))

    # one bench tile's six W1 GEMMs per tier, on operands split
    # beforehand, and the split of its ov blocks and t2 slices
    abc = (5, 3, 1)
    w1 = {}
    for prec in (None, "high", "default"):
        mode = tc.w1_mode(prec)
        big = ccsd_t._prepare(t1, t2, er, TILE, f32, None, None, 1.0,
                              "fused", mode)
        starts = [r * TILE for r in abc]
        t2w = {"jk": big["t2T_w1"], "kj": big["t2Ts_w1"]}
        ovf = {p: ccsd_t._ov_block(big, starts[p[0]], starts[p[1]])
               for p in tc.PERMS}

        def split(mode=mode, ovf=ovf, t2w=t2w, starts=starts):
            return ({p: tc.w1_ov(ovf[p], mode) for p in tc.PERMS},
                    {p: tc.w1_t2_slice(t2w[tc.W_PLAN[p]["t2"]],
                                       starts[p[2]], TILE, mode)
                     for p in tc.PERMS})

        ops = split()

        def gemms(ops=ops, prec=prec):
            return [tc.emit_w_dot(p, ops[0][p], ops[1][p], f32, TILE, NOCC,
                                  prec) for p in tc.PERMS]

        w1[str(prec)] = (cuda_ms(torch, gemms, 10),
                         cuda_ms(torch, split, 10) if prec else 0.0)
        del big, t2w, ovf, ops
    say(14, "(a) bench tile W1 GEMMs", ms_gemms_split=json.dumps(
        {k: f"{v[0]:.4f} {v[1]:.4f}" for k, v in w1.items()}),
        w1_gflop=f"{2 * 6 * TILE ** 3 * NOCC ** 3 * NVIR / 1e9:.1f}",
        seconds=f"{time.perf_counter() - t0_:.1f}")
    del er, t1, t2
    torch.cuda.empty_cache()

    # ---- (b) past the resident kernel's cap ------------------------------
    t0_ = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    er = testing.synthetic_eris(NOCC12, NVIR12, NAUX12, device=dev,
                                dtype=f32, generator=gen, build_ovvv=False)
    er = er._replace(oovv=None, ovvo=None)
    _, t1, t2 = rccsd.init_amps(er)
    top = tr.max_nocc(f32, "split")
    if not (top < NOCC12 and ccsd_t.auto_engine(
            "cuda", NOCC12, f32, "split") == "fused"):
        raise RuntimeError(f"auto at nocc {NOCC12} (resident cap {top}) "
                           "does not pick the fused engine")
    resb = {}
    for name, engine, kw in (
            ("fused", "fused", {}),
            ("auto_high", "auto", dict(dot_precision="high")),
            ("fused_default", "fused", dict(dot_precision="default"))):
        resb[name] = probe(t1, t2, er, NPROBE12, engine, record="fused",
                           **kw)
    if not (resb["auto_high"][2] > 0 and resb["auto_high"][3] == 0):
        raise RuntimeError(f"auto at 'high', nocc {NOCC12}: launches "
                           f"{resb['auto_high'][2:]}, not the combine kernel")
    xla = {}
    for prec in ("high", "default"):
        e_f2 = probe(t1, t2, er, 2, "fused", reps=1, dot_precision=prec)
        e_x2 = probe(t1, t2, er, 2, "xla", reps=1, dot_precision=prec)
        xla[prec] = (e_f2[0], e_x2[0], rel(e_f2[0], e_x2[0]), e_f2[2],
                     e_x2[1][0])
    e_full = resb["fused"][0]
    gaps = {"high_vs_full": rel(resb["auto_high"][0], e_full),
            "default_vs_full": rel(resb["fused_default"][0], e_full),
            "high_vs_xla_2": xla["high"][2],
            "default_vs_xla_2": xla["default"][2]}
    if not (max(gaps["high_vs_xla_2"], gaps["default_vs_xla_2"])
            <= RTOL_TIER and gaps["high_vs_full"] <= RTOL_SPLIT
            and min(v[2] for v in resb.values()) > 0):
        raise RuntimeError(f"bf16 tiers at nocc {NOCC12}: {gaps}")
    say(14, "(b) past the resident cap ok", shape=f"o={NOCC12},T={TILE},"
        f"nvir={NVIR12},naux={NAUX12}", resident_top_nocc=top,
        tiles=NPROBE12,
        ms_per_tile=json.dumps({k: fmt(v[1]) for k, v in resb.items()}),
        energies=json.dumps({k: repr(v[0]) for k, v in resb.items()}),
        gaps=json.dumps({k: f"{v:.3e}" for k, v in gaps.items()}),
        rtol_tier=RTOL_TIER, rtol_high_vs_full=RTOL_SPLIT,
        xla_2_tiles=json.dumps({k: dict(e_fused=repr(v[0]),
                                        e_xla=repr(v[1]),
                                        combine_launches=v[3],
                                        xla_ms_per_tile=f"{v[4]:.1f}")
                                for k, v in xla.items()}),
        launches=json.dumps({k: v[2:] for k, v in resb.items()}),
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        seconds=f"{time.perf_counter() - t0_:.1f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    del er, t1, t2
    torch.cuda.empty_cache()
    return launches


def w8_certify_phase(torch, smi, dev, scratch):
    """Phase 15: examples/w8_parity_certify.run at full width on the card
    (SCF with fp64 J/K on the card, fp32 CCSD and Lambda, the checkpoint,
    the fp64 certification), held to the JAX package's record.  The
    checkpoint goes to ``scratch``, which phase 16 reads.  The
    certification again from the checkpoint files (--reuse-scf, about
    10 s) is cut for phase 17's budget (tests/test_torch_w8_certify.py
    runs it on the CPU); phase 17 reruns benzene.run on its own SCF file
    and certifies from its own checkpoint through the same
    campaign.certify, bit for bit."""
    from pyscf_mpcc_tpu_torch.examples import w8_parity_certify as w8
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = w8.run(dev, scratch=scratch)
    sec = time.perf_counter() - t0
    shape = (r["nocc"], r["nvir"], r["naux"])
    checks = {
        "shape": shape == W8_SHAPE,
        "scf": abs(r["d_scf_vs_record"]) < ATOL_W8_SCF,
        "ccsd_converged": r["ccsd_converged"],
        "lambda_converged": r["lambda_converged"],
        "certified": abs(r["d_certified_vs_record"]) < ATOL_W8_CERTIFIED}
    if not all(checks.values()):
        raise RuntimeError(f"(H2O)8 certified campaign: {checks} {r}")
    say(15, "(H2O)8/cc-pVTZ scf ok", card=json.dumps(smi),
        nao=r["nao"], naux=r["naux"], e_scf=repr(r["e_scf"]),
        d_scf_vs_record=f"{r['d_scf_vs_record']:.2e}", atol=ATOL_W8_SCF,
        jk=json.dumps(r["jk"]), df_s=f"{r['df_s']:.1f}",
        scf_s=f"{r['scf_s']:.1f}", scf_cycles=r["scf_cycles"],
        jk_s=f"{r['jk_s']:.4f}", jk_host_s=f"{r['jk_host_s']:.3f}",
        jk_gap=f"{r['jk_gap']:.2e}", peak_gib=r["peak_scf_gib"])
    say(15, "(H2O)8/cc-pVTZ fp32 ccsd and lambda ok",
        card=json.dumps(smi), shape=json.dumps(shape),
        eris_s=f"{r['eris_s']:.2f}", ccsd=json.dumps(r["ccsd_diis"]),
        ccsd_cycles=r["ccsd_cycles"], ccsd_s=f"{r['ccsd_s']:.1f}",
        s_per_cycle=f"{r['ccsd_s_per_cycle']:.3f}",
        final_dt=f"{r['ccsd_normt']:.3e}", e32=repr(r["e32"]),
        peak_ccsd_gib=r["peak_ccsd_gib"],
        lam=json.dumps(r["lambda_diis"]),
        lambda_cycles=r["lambda_cycles"], lambda_s=f"{r['lambda_s']:.1f}",
        lambda_s_per_cycle=f"{r['lambda_s_per_cycle']:.3f}",
        final_dl=f"{r['lambda_dl']:.3e}",
        peak_lambda_gib=r["peak_lambda_gib"])
    say(15, "(H2O)8/cc-pVTZ certified ok", card=json.dumps(smi),
        e_lagr=repr(r["e_lagr"]),
        d_certified_vs_record=f"{r['d_certified_vs_record']:.2e}",
        atol=ATOL_W8_CERTIFIED, raw_fp32_gap=f"{r['raw_gap']:.3e}",
        d_e32_vs_tpu_record=f"{r['d_e32_vs_tpu_record']:.3e}",
        eris64_s=f"{r['eris64_s']:.2f}",
        residual64_s=f"{r['residual64_s']:.2f}", ntile64=r["ntile64"],
        peak_certify_gib=r["peak_certify_gib"],
        checkpoint_write_s=f"{r['checkpoint_s']:.1f}",
        seconds=f"{sec:.1f}")


def tile_sample(torch, dev, eris_of, t1, t2, tile, stride):
    """Every stride-th tile of the (T) tile list at edge ``tile`` through
    the fused engine's calls in fp32 (its prep, the combine kernel at
    K = 1) against engine='xla' in fp64 on fp64 integrals and the upcast
    amplitudes.  eris_of(dtype): the integrals in dtype on dev; t1, t2:
    the amplitudes (numpy).  Returns tiles, the combine kernel's launches
    (comparisons, outside the record), the fp32 and fp64 sums, the
    relative gap of the sums and of the worst tile, and ms a tile each."""
    from pyscf_mpcc_tpu_torch.cc import ccsd_t
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    f32, f64 = torch.float32, torch.float64
    sample = ccsd_t._tile_triples(-(-t1.shape[1] // tile))[::stride]

    def big_of(dtype, engine):
        amps = [torch.as_tensor(x).to(dev, dtype) for x in (t1, t2)]
        return ccsd_t._prepare(*amps, eris_of(dtype), tile, dtype, None,
                               None, 1.0, engine)

    big = big_of(f32, "fused")
    prep, eijk = ccsd_t.make_prep_fused(big), ccsd_t.fused_shared(big)[0]
    n0 = tc.launch_count
    t0 = time.perf_counter()
    e32 = torch.empty(len(sample), dtype=f64, device=dev)
    for n, abc in enumerate(sample):
        out = ccsd_t.stack_prep([prep(abc)])
        e32[n] = tc.tile_energy_fused_chunk(*out[:8], eijk, *out[8:10])[0]
    torch.cuda.synchronize()
    sec32 = time.perf_counter() - t0
    launches = tc.launch_count - n0
    del big, prep, eijk, out
    torch.cuda.empty_cache()
    big = big_of(f64, "xla")
    tile_energy = ccsd_t.make_tile_energy(big)
    t0 = time.perf_counter()
    e64 = torch.stack([tile_energy(abc) for abc in sample])
    torch.cuda.synchronize()
    sec64 = time.perf_counter() - t0
    del big, tile_energy
    torch.cuda.empty_cache()
    s32, s64 = float(e32.sum()), float(e64.sum())
    return dict(tiles=len(sample), launches=launches, sum32=s32, sum64=s64,
                rel_sum=abs(s32 - s64) / abs(s64),
                rel_tile=float(((e32 - e64).abs() / e64.abs()).max()),
                ms32=sec32 / len(sample) * 1e3,
                ms64=sec64 / len(sample) * 1e3)


def w8_triples_phase(torch, smi, dev, scratch, probe_ms):
    """Phase 16: the full (T) at (H2O)8/cc-pVTZ from phase 15's
    checkpoint in ``scratch`` (examples/w8_triples.run, every tile) at
    full precision and at dot-high through engine='auto', which must take
    the combine kernel and the resident kernel in mode split; every 82nd
    tile through the fused engine's calls in fp32 against engine='xla' in
    fp64 on fp64 integrals of the same checkpoint; the CCSD(T) pipeline
    through the facade (examples/w8_ccsd_pipeline) at --small in fp32
    against fp64.  probe_ms: the 64-tile probes' ms a tile (phases 4 and
    5), printed beside the full runs'.  Returns the launches: those of
    the full runs and of the fp32 pipeline join rows 1 and 3 of the
    record; the sample's and the fp64 pipeline's are apart."""
    from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
    from pyscf_mpcc_tpu_torch.examples import w8_ccsd_pipeline as pipe
    from pyscf_mpcc_tpu_torch.examples import w8_triples as w8t
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    f32, f64 = torch.float32, torch.float64

    # (a) the full (T), all tiles, through both kernels
    tc.launch_count = tr.launch_count = 0
    t0 = time.perf_counter()
    full, high = w8t.run("auto:highest,auto:dot-high", W8_TILE, dev,
                         scratch=scratch)
    sec = time.perf_counter() - t0
    launches = {"fused": tc.launch_count, "resident": tr.launch_count}
    if "error" in full or "error" in high:
        raise RuntimeError(f"full (T) run failed: {full} {high}")
    gap = high["e_t"] - full["e_t"]
    checks = {
        "n_tiles": full["n_tiles"] == high["n_tiles"] == W8_NTILES,
        "engines": (full["engine_resolved"], high["engine_resolved"],
                    high["w1_mode"]) == ("fused", "resident", "split"),
        "launches": launches == {"fused": W8_NTILES,
                                 "resident": W8_NTILES},
        "high_vs_full": abs(gap) <= ATOL_W8_ET_TIER,
        "full_vs_record": (abs(full["e_t"] - W8_ET_TPU["highest"])
                           <= ATOL_W8_ET_RECORD),
        "high_vs_record": (abs(high["e_t"] - W8_ET_TPU["dot-high"])
                           <= ATOL_W8_ET_RECORD)}
    if not all(checks.values()):
        raise RuntimeError(f"full (T): {checks} {launches} {full} {high}")
    for r, kind, rec in ((full, "fused", "highest"),
                         (high, "resident", "dot-high")):
        say(16, f"(H2O)8/cc-pVTZ full (T) {r['precision']} ok",
            card=json.dumps(smi), engine=r["engine_resolved"],
            w1_mode=r["w1_mode"], tiles=r["n_tiles"],
            launches=launches[kind], e_t=repr(r["e_t"]),
            d_tpu_record=f"{r['e_t'] - W8_ET_TPU[rec]:.3e}",
            atol_record=ATOL_W8_ET_RECORD, wall_s=f"{r['wall_T_sec']:.1f}",
            ms_per_tile=f"{r['ms_per_tile']:.4f}",
            probe_ms_per_tile=f"{probe_ms[kind]:.3f}",
            eris_s=f"{r['eris_s']:.2f}", peak_gib=r["peak_gib"],
            plan_gib=r["plan_gib"],
            clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    say(16, "dot-high against full precision ok", gap=f"{gap:.3e}",
        atol=ATOL_W8_ET_TIER, seconds=f"{sec:.1f}")

    # (b) a uniform sample of the tile list: fp32 through the fused
    # engine's calls against the 'xla' engine in fp64
    t0 = time.perf_counter()
    ck = w8t.load(scratch)

    def eris_of(dtype):
        return eris_mod.make_eris_df(
            ck["B"], ck["mo_full"][:, ck["frozen"]:], ck["fock_ao"],
            ck["nocc"], dtype=dtype, keep_ovvv=False, device=dev)

    s = tile_sample(torch, dev, eris_of, ck["t1"], ck["t2"], W8_TILE,
                    W8_SAMPLE_STRIDE)
    if not (s["tiles"] == -(-W8_NTILES // W8_SAMPLE_STRIDE)
            and s["launches"] == s["tiles"]
            and s["rel_sum"] <= RTOL_W8_SAMPLE
            and s["rel_tile"] <= RTOL_TILE_FP32):
        raise RuntimeError(f"(T) sample fp32 vs fp64: {s}")
    say(16, "every 82nd tile fp32 vs fp64 ok", tiles=s["tiles"],
        launches_not_in_record=s["launches"], e_sum_fp32=repr(s["sum32"]),
        e_sum_fp64=repr(s["sum64"]), rel_sum=f"{s['rel_sum']:.3e}",
        rtol_sum=RTOL_W8_SAMPLE, rel_tile_max=f"{s['rel_tile']:.3e}",
        rtol_tile=RTOL_TILE_FP32, ms_per_tile_fp32=f"{s['ms32']:.3f}",
        ms_per_tile_fp64_xla=f"{s['ms64']:.3f}",
        e_t_estimate_from_sample=f"{2 * W8_SAMPLE_STRIDE * s['sum32']:.6f}",
        seconds=f"{time.perf_counter() - t0:.1f}")

    # (c) the CCSD(T) pipeline through the facade at --small
    t0 = time.perf_counter()
    tc.launch_count = 0
    p32 = pipe.run(True, dev, f32)
    pipe32_launches = tc.launch_count
    launches["fused"] += pipe32_launches
    n0 = tc.launch_count
    p64 = pipe.run(True, dev, f64)
    pipe64_launches = tc.launch_count - n0
    d = (p32["e_corr"] + p32["e_t"]) - (p64["e_corr"] + p64["e_t"])
    if not (p32["ccsd_converged"] and p64["ccsd_converged"]
            and abs(d) <= ATOL_MAIN_FP32
            and pipe32_launches > 0 and pipe64_launches > 0):
        raise RuntimeError(f"pipeline --small fp32 vs fp64: {d} "
                           f"({pipe32_launches}, {pipe64_launches} "
                           f"launches) {p32} {p64}")
    say(16, "pipeline --small fp32 vs fp64 ok", system=json.dumps(
        p32["system"]), e_scf=repr(p32["e_scf"]), e_corr=repr(p32["e_corr"]),
        e_t=repr(p32["e_t"]), d_e_corr_plus_e_t=f"{d:.2e}",
        atol=ATOL_MAIN_FP32, cycles_fp32=p32["ccsd_cycles"],
        cycles_fp64=p64["ccsd_cycles"],
        launches_fp32=pipe32_launches,
        launches_fp64_not_in_record=pipe64_launches,
        seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    return launches


def benzene_phase(torch, smi, dev, scratch):
    """Phase 17: examples/benzene.run at cc-pVTZ on the card (the DF-RHF
    with fp64 J/K on the card, fp32 DF-MP2, CCSD, the full (T) through
    engine='auto', Lambda, the checkpoint in ``scratch`` and the fp64
    certification), held to the JAX package's pins and record; MP2 in
    fp64 on the same MOs; the run again on its own SCF file (reused;
    E_SCF, MP2 and CCSD bit for bit); the certification again from the
    checkpoint files alone (--stage64), bit for bit; every 11th tile
    through the fused engine's calls in fp32 against engine='xla' in
    fp64.  Returns
    the combine kernel's launches of the run, which join row 1 of the
    record (the sample's are apart)."""
    from pyscf_mpcc_tpu_torch.cc import eris as eris_mod
    from pyscf_mpcc_tpu_torch.examples import benzene as bz
    from pyscf_mpcc_tpu_torch.mp import mp2
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    f64 = torch.float64
    torch.cuda.empty_cache()
    tc.launch_count = 0
    t0 = time.perf_counter()
    r = bz.run(dev, "cc-pvtz", certify=True, triples=True, scratch=scratch)
    sec = time.perf_counter() - t0
    launches = tc.launch_count

    # MP2 in fp64 on the same MOs: the integrals of the checkpoint in
    # fp64, which the sample's reference reuses
    scf, amps = bz.load_checkpoint("cc-pvtz", scratch)
    nocc = int(scf["nelectron"]) // 2

    def eris_of(dtype):
        return eris_mod.make_eris_df(scf["B"], scf["mo_full"],
                                     scf["fock_ao"], nocc, dtype=dtype,
                                     keep_ovvv=False, device=dev)

    er64 = eris_of(f64)
    e_mp2_64 = float(mp2.df_kernel(er64.mo_energy[:nocc],
                                   er64.mo_energy[nocc:], er64.Lov)[0])
    d_mp2 = r["e_corr_mp2_fp32"] - e_mp2_64
    shape = (r["nocc"], r["nvir"], r["naux"])
    checks = {
        "shape": shape == BZ_SHAPE and r["nao"] == BZ_NAO,
        "scf": abs(r["d_scf_vs_pin"]) < ATOL_BZ_SCF,
        "mp2_fp32_vs_fp64": abs(d_mp2) < ATOL_MAIN_FP32,
        "ccsd_converged": r["converged"],
        "lambda_converged": r["lambda_converged"],
        "triples": (r["triples_engine"], r["triples_tile"],
                    r["triples_tiles"]) == ("fused", BZ_TILE, BZ_NTILES),
        "launches": launches == r["triples_launches"] == BZ_NTILES,
        "certified": abs(r["d_certified_vs_record"]) < ATOL_BZ_CERTIFIED}
    if not all(checks.values()):
        raise RuntimeError(f"benzene/cc-pVTZ campaign: {checks} "
                           f"{launches} launches, MP2 fp64 {e_mp2_64!r} "
                           f"{r}")
    st, pk = r["stage_s"], r["peak_gib"]
    say(17, "benzene/cc-pVTZ scf and mp2 ok", card=json.dumps(smi),
        nao=r["nao"], shape=json.dumps(shape), e_scf=repr(r["e_scf"]),
        d_scf_vs_pin=f"{r['d_scf_vs_pin']:.2e}", atol=ATOL_BZ_SCF,
        jk=json.dumps(r["jk"]), df_s=f"{r['df_s']:.1f}",
        scf_cycles=r["scf_cycles"], jk_gap=f"{r['jk_gap']:.2e}",
        e_mp2_fp32=repr(r["e_corr_mp2_fp32"]), e_mp2_fp64=repr(e_mp2_64),
        d_mp2_fp32_vs_fp64=f"{d_mp2:.2e}", atol_mp2=ATOL_MAIN_FP32,
        d_mp2_vs_pin=f"{r['d_mp2_vs_pin']:.2e}")
    say(17, "benzene/cc-pVTZ fp32 ccsd, (T) and lambda ok",
        card=json.dumps(smi), ccsd=json.dumps(r["ccsd_diis"]),
        ccsd_cycles=r["ccsd_cycles"], final_dt=f"{r['ccsd_normt']:.3e}",
        e_corr_fp32=repr(r["e_corr_fp32"]),
        ccsd_solve_s=f"{r['ccsd_solve_sec']:.2f}",
        reference_16core_cpu_ccsd_s=r["reference_ccsd_sec"],
        speedup_vs_reference=r["speedup_vs_reference"],
        e_t=repr(r["e_t_fp32"]), engine=r["triples_engine"],
        tile=r["triples_tile"], tiles=r["triples_tiles"],
        launches=launches,
        ms_per_tile=f"{r['triples_ms_per_tile']:.4f}",
        lam=json.dumps(r["lambda_diis"]), lambda_cycles=r["lambda_cycles"],
        final_dl=f"{r['lambda_dl']:.3e}")
    say(17, "benzene/cc-pVTZ certified ok", card=json.dumps(smi),
        e_lagr=repr(r["e_corr_fp64_lagrangian"]),
        d_certified_vs_record=f"{r['d_certified_vs_record']:.2e}",
        atol=ATOL_BZ_CERTIFIED, raw_fp32_gap=f"{r['fp32_raw_dE']:.3e}",
        ntile64=r["ntile64"],
        stage_s=json.dumps({k: round(v, 3) for k, v in st.items()}),
        peak_gib=json.dumps(pk), run_s=f"{sec:.1f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))

    # benzene.run again on its own checkpoint: the SCF reused from its
    # file (the JAX script's SCF cache), then the integrals, MP2 and CCSD,
    # each bit for bit against the first run
    t0 = time.perf_counter()
    r2 = bz.run(dev, "cc-pvtz", certify=False, triples=False,
                scratch=scratch)
    keys = ("e_scf", "e_corr_mp2_fp32", "e_corr_fp32", "ccsd_cycles")
    if not (r2["scf_reused"] and all(r2[k] == r[k] for k in keys)):
        raise RuntimeError(f"rerun on the SCF checkpoint: "
                           f"{ {k: (r2[k], r[k]) for k in keys} } "
                           f"reused {r2['scf_reused']}")
    say(17, "rerun from the scf checkpoint ok", scf_reused=True,
        bit_equal=",".join(keys), e_corr_fp32=repr(r2["e_corr_fp32"]),
        stage_s=json.dumps({k: round(v, 3)
                            for k, v in r2["stage_s"].items()}),
        seconds=f"{time.perf_counter() - t0:.1f}")

    # the certification again from the checkpoint files alone (--stage64)
    t0 = time.perf_counter()
    e_l64, _ = bz.certify_from_checkpoint("cc-pvtz", dev, scratch)
    if e_l64 != r["e_corr_fp64_lagrangian"]:
        raise RuntimeError(f"--stage64: {e_l64!r} against "
                           f"{r['e_corr_fp64_lagrangian']!r}")
    say(17, "certification from the checkpoint ok", e_lagr=repr(e_l64),
        bit_equal=True, seconds=f"{time.perf_counter() - t0:.1f}")

    # every 11th tile, fp32 through the fused engine's calls against
    # engine='xla' in fp64
    t0 = time.perf_counter()
    s = tile_sample(torch, dev, lambda dt: er64 if dt == f64 else
                    eris_of(dt), amps["t1"], amps["t2"], BZ_TILE,
                    BZ_SAMPLE_STRIDE)
    del er64
    if not (s["tiles"] == BZ_NTILES // BZ_SAMPLE_STRIDE
            and s["launches"] == s["tiles"]
            and s["rel_sum"] <= RTOL_W8_SAMPLE
            and s["rel_tile"] <= RTOL_TILE_FP32):
        raise RuntimeError(f"benzene (T) sample fp32 vs fp64: {s}")
    say(17, "every 11th tile fp32 vs fp64 ok", tiles=s["tiles"],
        launches_not_in_record=s["launches"], e_sum_fp32=repr(s["sum32"]),
        e_sum_fp64=repr(s["sum64"]), rel_sum=f"{s['rel_sum']:.3e}",
        rtol_sum=RTOL_W8_SAMPLE, rel_tile_max=f"{s['rel_tile']:.3e}",
        rtol_tile=RTOL_TILE_FP32, ms_per_tile_fp32=f"{s['ms32']:.3f}",
        ms_per_tile_fp64_xla=f"{s['ms64']:.3f}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    torch.cuda.empty_cache()
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from pyscf_mpcc_tpu_torch import config, testing
    from pyscf_mpcc_tpu_torch.gto import native
    from pyscf_mpcc_tpu_torch import ao2mo, gto
    from pyscf_mpcc_tpu_torch.cc import ccsd_t, lambda_ad, rccsd
    from pyscf_mpcc_tpu_torch.cc.driver import CCSD
    from pyscf_mpcc_tpu_torch.cc.eris import RERIs
    from pyscf_mpcc_tpu_torch.lib import device as devpol
    from pyscf_mpcc_tpu_torch.lib import memory
    from pyscf_mpcc_tpu_torch.ops import _build
    from pyscf_mpcc_tpu_torch.ops import triples_combine as tc
    from pyscf_mpcc_tpu_torch.ops import triples_resident as tr
    from pyscf_mpcc_tpu_torch.scf import RHF
    from pyscf_mpcc_tpu_torch.tools import slab_loop_probe as sp
    from pyscf_mpcc_tpu_torch.tools import triples_probe_v6 as pv

    f64, f32 = torch.float64, torch.float32
    dev = torch.device("cuda")

    # ---- phase 0: environment --------------------------------------------
    t_start = t_phase = time.perf_counter()
    smi = nvidia_smi("name,power.limit").strip()
    devpol.set_fp32_precision()
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    t0 = time.perf_counter()
    kernels = ("triples_combine", "triples_resident", "triples_probe",
               "slab_relayout")
    _build.load_all(kernels)
    build_s = time.perf_counter() - t0
    say(0, "env", torch=torch.__version__, cuda=torch.version.cuda,
        card=json.dumps(smi), gpus=torch.cuda.device_count(),
        native_integrals=native.available(),
        opt_einsum=torch.backends.opt_einsum.is_available(),
        kernel_build_s=f"{build_s:.2f}")
    for name in kernels:
        for ln in _build.build_info[name]["log"].splitlines():
            if "registers" in ln or "spill" in ln or "wgmma" in ln:
                say(0, "ptxas", kernel=name, line=json.dumps(ln.strip()))
    say(0, "clocks", sm_max_power_temp=json.dumps(nvidia_smi(CLOCKS)))

    say(0, "done", seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()

    # ---- phase 1: kernel against its plain version -----------------------
    nchk = 0
    for nocc in (3, 5):
        for mode in (None, "exclude_active", "only_active"):
            for K in (1, 4):
                t1, t2, er = testing.triples_tensors(
                    *testing.random_triples_problem(
                        nocc, 7, 11 + nocc, naux=11 if K == 4 else None),
                    dev, f64)
                act = dict(act_hole=[0, 2], act_particle=[1, 3, 4]) \
                    if mode else dict(act_hole=None, act_particle=None)
                big = ccsd_t._prepare(t1, t2, er, 3, f64, act["act_hole"],
                                      act["act_particle"], 1.0, "fused")
                prep = ccsd_t.make_prep_fused(big)
                eijk, actocc = ccsd_t.fused_shared(big)
                trips = ccsd_t._tile_triples(big["nvp"] // 3)
                out = ccsd_t.stack_prep([prep(abc) for abc in trips[:K]])
                kw = dict(actv=out[10], actocc=actocc, act_mode=mode) \
                    if mode else {}
                args = (*out[:8], eijk, *out[8:10])
                e_k = tc.tile_energy_fused_chunk(*args, **kw)
                e_p = tc.tile_energy_fused_reference_chunk(*args, **kw)
                torch.cuda.synchronize()
                if not torch.isfinite(e_k).all():
                    raise RuntimeError("non-finite kernel energies")
                torch.testing.assert_close(e_k, e_p, rtol=RTOL_FP64,
                                           atol=1e-14)
                nchk += 1
    # fp64 at nocc=28, the top of the staged form (V-term inputs read from
    # device memory), and at 30 and 32, the unstaged form (W exceeds
    # smem; at 32 its t2 blocks take the whole 48 KB default)
    for nocc in (28, 30, 32):
        t1, t2, er = testing.triples_tensors(
            *testing.random_triples_problem(nocc, 4, 9), dev, f64)
        big = ccsd_t._prepare(t1, t2, er, 2, f64, None, None, 1.0, "fused")
        out = ccsd_t.make_prep_fused(big)((1, 1, 0))
        args = (*out[:8], ccsd_t.fused_shared(big)[0], *out[8:10])
        torch.testing.assert_close(tc.tile_energy_fused(*args),
                                   tc.tile_energy_fused_reference(*args),
                                   rtol=RTOL_FP64, atol=1e-14)
        nchk += 1
    say(1, "random problems fp64 ok", cases=nchk, rtol=RTOL_FP64)
    # phase 17's width before its full run: nocc 21 (odd, not a multiple
    # of the 16-byte vector, so the W build loads one value at a time) and
    # a ragged nvir (19 at tile 8: the last tile row pads 5 virtuals), DF
    # factors in place of ovvv, every tile of the list at K = 1 as the
    # path launches them, in fp32 and fp64.  At nocc 21 both dtypes take
    # the staged form with the V-term inputs in shared memory; the
    # unstaged form starts past 28 in fp64 (checked above) and 36 in fp32
    lib = tc._lib()
    for dtype, rtol in ((f32, RTOL_TILE_FP32), (f64, RTOL_FP64)):
        t1, t2, er = testing.triples_tensors(
            *testing.random_triples_problem(21, 19, 21, naux=30), dev, dtype)
        big = ccsd_t._prepare(t1, t2, er, 8, dtype, None, None, 1.0,
                              "fused")
        prep, eijk = ccsd_t.make_prep_fused(big), ccsd_t.fused_shared(big)[0]
        trips = ccsd_t._tile_triples(big["nvp"] // 8)
        err = 0.0
        for abc in trips:
            out = ccsd_t.stack_prep([prep(abc)])
            args = (*out[:8], eijk, *out[8:10])
            e_k = tc.tile_energy_fused_chunk(*args)
            e_p = tc.tile_energy_fused_reference_chunk(*args)
            torch.testing.assert_close(e_k, e_p, rtol=rtol, atol=1e-14)
            err = max(err, float((e_k - e_p).abs().max()
                                 / e_p.abs().max()))
        isz = dtype.itemsize
        say(1, "nocc 21, ragged nvir ok", dtype=str(dtype), nvir=19, tile=8,
            tiles=len(trips), rtol=rtol, rel_err_max=f"{err:.2e}",
            staged=lib.triples_combine_staged_bytes(21, isz)
            <= lib.triples_combine_smem_max(),
            v_staged=bool(lib.triples_combine_v_staged(21, isz)))
    del big, prep, out, args

    gen = torch.Generator(device=dev).manual_seed(0)
    beris = testing.synthetic_eris(NOCC, NVIR, NAUX, device=dev, dtype=f32,
                                   generator=gen, build_ovvv=False)
    _, bt1, bt2 = rccsd.init_amps(beris)
    big = ccsd_t._prepare(bt1, bt2, beris, TILE, f32, None, None, 1.0,
                          "fused")
    out = ccsd_t.make_prep_fused(big)((5, 3, 1))
    eijk, _ = ccsd_t.fused_shared(big)
    args = (*out[:8], eijk, *out[8:10])
    del big
    n0 = tc.launch_count
    e_k = float(tc.tile_energy_fused(*args))
    e_p = float(tc.tile_energy_fused_reference(*args))
    e_64 = float(tc.tile_energy_fused_reference(
        *[[w.double() for w in a] if isinstance(a, list)
          else (a.double() if a.is_floating_point() else a) for a in args]))
    tile_err = abs(e_k - e_p)
    if not (tile_err <= RTOL_TILE_FP32 * abs(e_p)):
        raise RuntimeError(f"fp32 tile: kernel {e_k!r} vs plain {e_p!r}")
    ms_k = cuda_ms(torch, lambda: tc.tile_energy_fused(*args), 20)
    ms_p = cuda_ms(torch, lambda: tc.tile_energy_fused_reference(*args), 5)
    # bound: read the six W1 streams and the slices once; the w2 dots,
    # 6 o^4 multiply-adds per cell of nonzero weight, in fp32
    ncell = int((ccsd_t._weights([5 * TILE, 3 * TILE, TILE], TILE, f64, dev)
                 != 0).sum())
    comb_bound = bound_ms(nbytes(args) + 8 * TILE ** 3,
                          {"fp32": 2 * 6 * ncell * NOCC ** 4})
    say(1, "bench tile fp32 ok", shape=f"o={NOCC},T={TILE},nvir={NVIR}",
        e_kernel=repr(e_k), e_plain=repr(e_p), e_fp64_plain=repr(e_64),
        abs_err=f"{tile_err:.3e}", rtol=RTOL_TILE_FP32,
        kernel_ms=f"{ms_k:.3f}", plain_ms=f"{ms_p:.3f}",
        bound_ms=f"{comb_bound[0]:.3f}", bound_by=comb_bound[1],
        launches=tc.launch_count - n0,
        share_of_bound=f"{comb_bound[0] / ms_k:.3f}")
    # where a cell's time goes: the kernel's profile form stamps the SM
    # clock at each phase boundary of every cell (a barrier before each
    # stamp); shares of the summed clocks of the cells of nonzero weight,
    # with the profile form's time per tile
    e_prof, cyc = tc.tile_energy_fused_profile(*args)
    if not abs(e_prof.item() - e_k) <= RTOL_TILE_FP32 * abs(e_p):
        raise RuntimeError(f"profile form: {e_prof.item()!r} vs kernel "
                           f"{e_k!r}")
    ms_prof = cuda_ms(torch, lambda: tc.tile_energy_fused_profile(*args), 10)
    tot = cyc[..., -1].sum().item()
    shares = {name: cyc[..., n].sum().item() / tot
              for n, name in enumerate(tc.PHASES)}
    busy = cyc[..., -1][cyc[..., -1] > 0].double()
    say(1, "bench tile phase split", profile_ms=f"{ms_prof:.4f}",
        shares=json.dumps({k: round(v, 4) for k, v in shares.items()}),
        ms_by_phase=json.dumps({k: round(v * ms_prof, 4)
                                for k, v in shares.items()}),
        cells=busy.numel(), clocks_per_cell_mean=f"{busy.mean():.0f}",
        clocks_per_cell_max=f"{busy.max():.0f}",
        abs_err=f"{abs(e_prof.item() - e_p):.3e}")
    del args, out

    say(1, "done", seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()

    # ---- phase 2: pinned fp64 energies on the card -----------------------
    def rhf(geom, df=False):
        mf = RHF(testing.mol_of(geom))
        if df:
            mf.density_fit()
        mf.conv_tol = 1e-13
        mf.conv_tol_grad = 1e-10
        return mf.run()

    t0 = time.perf_counter()
    cc = CCSD(rhf("sym"), device=dev, dtype=f64)
    cc.set(conv_tol=1e-10, conv_tol_normt=1e-8).run()
    d_ccsd = cc.e_corr - E_CCSD_SYM
    if not (cc.converged and abs(d_ccsd) < 1e-7):
        raise RuntimeError(f"E(CCSD) {cc.e_corr!r} off the pin by {d_ccsd}")
    tilt = CCSD(rhf("tilt"), device=dev, dtype=f64)
    tilt.set(conv_tol=1e-12, conv_tol_normt=1e-10, max_cycle=200).run()
    n0 = tc.launch_count
    e_t = tilt.ccsd_t()
    nl = tc.launch_count - n0
    d_t = e_t - E_T_TILT
    if not (tilt.converged and abs(d_t) < 1e-9 and nl > 0):
        raise RuntimeError(f"E(T) {e_t!r} off the pin by {d_t} "
                           f"({nl} kernel launches)")
    say(2, "pinned fp64 ok", e_ccsd_err=f"{d_ccsd:.2e}",
        e_t=repr(e_t), e_t_err=f"{d_t:.2e}", kernel_launches=nl,
        seconds=f"{time.perf_counter() - t0:.1f}")

    say(2, "done", seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()

    # ---- phase 3: the DF main path through the user entry points ---------
    t0 = time.perf_counter()
    mf = RHF(testing.mol_of("sym")).density_fit().run()
    tc.launch_count = 0
    cc32 = CCSD(mf, device=dev).run()
    et32 = cc32.ccsd_t()
    main_launches = tc.launch_count
    t_main = time.perf_counter() - t0
    cc64 = CCSD(mf, device=dev, dtype=f64).run()
    et64 = cc64.ccsd_t()
    de, dt = cc32.e_corr - cc64.e_corr, et32 - et64
    if not (cc32.converged and cc64.converged and main_launches > 0
            and abs(de) < ATOL_MAIN_FP32 and abs(dt) < ATOL_MAIN_FP32):
        raise RuntimeError(f"DF main path fp32 vs fp64: dE_corr={de}, "
                           f"dE(T)={dt}, launches={main_launches}")
    say(3, "DF main path ok", dtype=str(cc32.t2.dtype),
        e_corr=repr(cc32.e_corr), e_t=repr(et32), d_e_corr=f"{de:.2e}",
        d_e_t=f"{dt:.2e}", kernel_launches=main_launches,
        seconds_fp32=f"{t_main:.1f}")
    # the kernel against its plain version on one tile of this path's own
    # (T) inputs (nocc=5, padded virtuals), after the launch count was read
    big = ccsd_t._prepare(cc32.t1, cc32.t2, cc32.eris, TILE, f32, None,
                          None, 1.0, "fused")
    out = ccsd_t.make_prep_fused(big)((2, 1, 0))
    args = (*out[:8], ccsd_t.fused_shared(big)[0], *out[8:10])
    torch.testing.assert_close(tc.tile_energy_fused(*args),
                               tc.tile_energy_fused_reference(*args),
                               rtol=RTOL_TILE_FP32, atol=1e-12)
    say(3, "main-path tile ok", shape=f"o={big['o']},T={TILE}",
        nvir=cc32.t1.shape[1], rtol=RTOL_TILE_FP32)
    del cc32, cc64, big, out, args

    say(3, "done", seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()

    # ---- phase 4: the (H2O)8 shape ---------------------------------------
    torch.cuda.reset_peak_memory_stats()
    ntile = memory.plan_ladder_ntile(NOCC, NVIR, NAUX, f32, device=dev)
    rccsd.update_amps(bt1, bt2, beris, ntile=ntile)
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        a1, a2 = rccsd.update_amps(bt1, bt2, beris, ntile=ntile)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    sec = statistics.median(times)
    fl = rccsd.flops_per_update(NOCC, NVIR, NAUX)
    fl_exec = rccsd.flops_per_update(NOCC, NVIR, NAUX, ntile)
    peak = torch.cuda.max_memory_allocated()
    del a1
    if not torch.isfinite(a2).all():
        raise RuntimeError("non-finite fp32 sweep")
    say(4, "ccsd sweep fp32", ntile=ntile,
        sec=" ".join(f"{t:.4f}" for t in times), sec_median=f"{sec:.4f}",
        tflops_dense_equiv=f"{fl / sec / 1e12:.2f}",
        tflops_executed=f"{fl_exec / sec / 1e12:.2f}",
        peak_gib=f"{peak / 2**30:.2f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    e64 = RERIs(*(None if x is None else x.double() for x in beris))
    ntile64 = memory.plan_ladder_ntile(NOCC, NVIR, NAUX, f64, device=dev)
    t0 = time.perf_counter()
    _, b2 = rccsd.update_amps(bt1.double(), bt2.double(), e64,
                              ntile=ntile64)
    torch.cuda.synchronize()
    sec64 = time.perf_counter() - t0
    rel = float(torch.linalg.norm(a2.double() - b2) / torch.linalg.norm(b2))
    del e64, b2, a2
    if not rel < RTOL_SWEEP_FP32:
        raise RuntimeError(f"fp32 sweep deviates from fp64 by {rel}")
    say(4, "fp32 vs fp64 sweep ok", rel_t2_diff=f"{rel:.3e}",
        rtol=RTOL_SWEEP_FP32, ntile_fp64=ntile64, sec_fp64=f"{sec64:.3f}")

    def probe(engine, launches, **kw):
        """E(T) over the first NPROBE tiles through ccsd_t.kernel (the
        entry point) after a warm-up run; launches is the kernel module
        whose count is zeroed just before the timed run.  Returns
        (energy, ms per tile, launches in the timed run)."""
        orig = ccsd_t._tile_triples
        ccsd_t._tile_triples = lambda nvt: orig(nvt)[:NPROBE]
        try:
            ccsd_t.kernel(bt1, bt2, beris, tile=TILE, engine=engine, **kw)
            torch.cuda.synchronize()
            launches.launch_count = 0
            t0 = time.perf_counter()
            e = ccsd_t.kernel(bt1, bt2, beris, tile=TILE, engine=engine,
                              **kw)
            ms = (time.perf_counter() - t0) / NPROBE * 1e3
            n = launches.launch_count
        finally:
            ccsd_t._tile_triples = orig
        if not (e == e and abs(e) < float("inf")):
            raise RuntimeError(f"non-finite (T) probe energy {e}")
        return e, ms, n

    e_probe, probe_ms, comb_launches = probe("fused", tc)
    if comb_launches == 0:
        raise RuntimeError("the fused probe launched no combine kernel")
    say(4, "(T) probe", tiles=NPROBE, launches=comb_launches,
        ms_per_tile=f"{probe_ms:.3f}",
        kernel_ms_per_tile=f"{ms_k:.3f}", plain_ms_per_tile=f"{ms_p:.3f}",
        e_probe=repr(e_probe), clocks_after=json.dumps(nvidia_smi(CLOCKS)),
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        max_memory_mb=config.MAX_MEMORY)

    # the chunk form (tile_energy_fused_chunk): the probe at chunk=4, and
    # the kernel alone on four stacked tiles (K=4) against the same tiles
    # one launch each (K=1)
    e_c4, probe_ms_c4, c4_launches = probe("fused", tc, chunk=4)
    if not (abs(e_c4 - e_probe) <= RTOL_TILE_FP32 * abs(e_probe)
            and c4_launches > 0):
        raise RuntimeError(f"chunk=4 probe {e_c4!r} vs chunk=1 {e_probe!r} "
                           f"({c4_launches} launches)")
    bigc = ccsd_t._prepare(bt1, bt2, beris, TILE, f32, None, None, 1.0,
                           "fused")
    prepc = ccsd_t.make_prep_fused(bigc)
    eijk_c = ccsd_t.fused_shared(bigc)[0]
    trips4 = ccsd_t._tile_triples(bigc["nvp"] // TILE)[:4]
    outs = [prepc(abc) for abc in trips4]
    del bigc, prepc
    ncell4 = sum(int((ccsd_t._weights([a * TILE, b * TILE, c * TILE], TILE,
                                      f64, dev) != 0).sum())
                 for a, b, c in trips4)
    args1 = [(*x[:8], eijk_c, *x[8:10]) for x in outs]
    c4 = ccsd_t.stack_prep(outs)
    args4 = (*c4[:8], eijk_c, *c4[8:10])
    e_k4 = tc.tile_energy_fused_chunk(*args4)
    e_k1 = torch.stack([tc.tile_energy_fused(*a) for a in args1])
    torch.testing.assert_close(e_k4, e_k1, rtol=RTOL_FP64, atol=1e-14)
    chunk_err = float((e_k4 - tc.tile_energy_fused_reference_chunk(
        *args4)).abs().max())
    if not chunk_err <= RTOL_TILE_FP32 * float(e_k4.abs().max()):
        raise RuntimeError(f"chunk kernel vs plain: {chunk_err}")
    chunk_ms = cuda_ms(torch, lambda: tc.tile_energy_fused_chunk(*args4),
                       10) / 4
    single_ms = cuda_ms(torch, lambda: [tc.tile_energy_fused(*a)
                                         for a in args1], 10) / 4
    chunk_plain_ms = cuda_ms(
        torch, lambda: tc.tile_energy_fused_reference_chunk(*args4), 3) / 4
    chunk_bound = bound_ms(nbytes(args4) + 4 * 8 * TILE ** 3,
                           {"fp32": 2 * 6 * ncell4 * NOCC ** 4})
    say(4, "(T) probe chunk=4", tiles=NPROBE, launches=c4_launches,
        ms_per_tile=f"{probe_ms_c4:.3f}", ms_per_tile_chunk1=f"{probe_ms:.3f}",
        e_probe=repr(e_c4), kernel_ms_per_tile_k4=f"{chunk_ms:.3f}",
        kernel_ms_per_tile_k1=f"{single_ms:.3f}",
        plain_ms_per_tile_k4=f"{chunk_plain_ms:.3f}",
        bound_ms_per_tile=f"{chunk_bound[0] / 4:.3f}", cells=ncell4)
    del outs, args1, c4, args4

    say(4, "done", seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()

    # ---- phase 5: the resident (T) engine --------------------------------
    def resident_chunk(nocc, nvir, seed, dtype, tile, tiles, act, df,
                       mode="f32"):
        t1, t2, er = testing.triples_tensors(
            *testing.random_triples_problem(nocc, nvir, seed,
                                            naux=11 if df else None),
            dev, dtype)
        kw = dict(act_hole=[0, 2], act_particle=[1, 3, 4]) if act \
            else dict(act_hole=None, act_particle=None)
        big = ccsd_t._prepare(t1, t2, er, tile, dtype, kw["act_hole"],
                              kw["act_particle"], 1.0, "resident", mode)
        prep = ccsd_t.make_prep_resident(big)
        eijk, actocc = ccsd_t.fused_shared(big)
        trips = ccsd_t._tile_triples(big["nvp"] // tile)
        out = ccsd_t.stack_prep_resident([prep(trips[n]) for n in tiles])
        akw = dict(act3=out[9], actocc=actocc, act_mode=act) if act else {}
        return (*out[:7], eijk, *out[7:9]), akw

    def check_resident(args, akw, mode, rtol, atol):
        e_k = tr.tile_energy_resident_chunk(*args, mode=mode, **akw)
        e_p = tr.tile_energy_resident_reference_chunk(*args, mode=mode,
                                                      **akw)
        torch.cuda.synchronize()
        if not torch.isfinite(e_k).all():
            raise RuntimeError("non-finite resident kernel energies")
        torch.testing.assert_close(e_k, e_p, rtol=rtol, atol=atol)

    nchk = 0
    for nocc in (3, 5):
        for act in (None, "exclude_active", "only_active"):
            for K in (1, 4):
                check_resident(*resident_chunk(nocc, 7, 11 + nocc, f64, 3,
                                               range(K), act, K == 4),
                               "f32", RTOL_FP64, 1e-14)
                nchk += 1
    # odd tile: nvir=7 at tile 4 pads the virtuals (weight-zero cells)
    check_resident(*resident_chunk(4, 7, 9, f64, 4, range(4), None, False),
                   "f32", RTOL_FP64, 1e-14)
    nchk += 1
    for mode in ("split", "bf16"):
        for act in (None, "only_active"):
            check_resident(*resident_chunk(5, 9, 4, f32, 3, range(4), act,
                                           True, mode),
                           mode, RTOL_TILE_FP32, 1e-9)
            nchk += 1
    say(5, "random problems ok", cases=nchk, rtol_fp64_f32=RTOL_FP64,
        rtol_fp32_split_bf16=RTOL_TILE_FP32)

    # (b) one tile of the bench shape in each W1 mode, through the prep of
    # that mode (split, bf16: t2 split into bf16 once per call, each tile's
    # ov blocks once per tile)
    abc = (5, 3, 1)
    # k depth of one staged chunk of the kernel in each mode (f32:
    # ffma_bk<float> of triples_resident.cu); the W1 share is the kernel's
    # time less its time with F cut to one chunk
    kchunk = {"f32": 16, **tr.MMA_KC}
    bigf = ccsd_t._prepare(bt1, bt2, beris, TILE, f32, None, None, 1.0,
                           "fused")
    prep_f = ccsd_t.make_prep_fused(bigf)
    eijk = ccsd_t.fused_shared(bigf)[0]

    def fused_path():
        o = prep_f(abc)
        return tc.tile_energy_fused(*o[:8], eijk, *o[8:10])

    def to64(a):
        return [to64(x) for x in a] if isinstance(a, (list, tuple)) \
            else a.double()

    def cut_f(x, mode, axis):
        """A W1 operand (or (hi, lo) pair) with f cut to its first k-chunk:
        the f axis of a dense one, the chunk axis of a tiled one."""
        if isinstance(x, tuple):
            return tuple(cut_f(h, mode, axis) for h in x)
        if mode == "f32":
            return x.narrow(axis, 0, kchunk[mode]).contiguous()
        return x.narrow(axis, 0, 1).contiguous()

    res = {}
    w1_flops = 2 * 6 * ncell * NOCC ** 3 * NVIR
    for mode in ("f32", "split", "bf16"):
        bigr = ccsd_t._prepare(bt1, bt2, beris, TILE, f32, None, None, 1.0,
                               "resident", mode)
        split_ms = (cuda_ms(torch, lambda: tr.t2_operand(
            bigr["t2T"], mode), 3) if mode != "f32" else 0.0)
        prep_r = ccsd_t.make_prep_resident(bigr)
        out = prep_r(abc)
        rargs = (*out[:7], eijk, *out[7:9])
        if mode == "f32":
            e_r64 = float(tr.tile_energy_resident_reference(
                *to64(rargs), mode="f32"))

        def resident_path(prep_r=prep_r, mode=mode):
            o = prep_r(abc)
            return tr.tile_energy_resident(*o[:7], eijk, *o[7:9], mode=mode)

        kc = kchunk[mode]
        # t2: f is axis 1 dense, the chunk axis 1 tiled; ov: 3 and 2
        cargs = ([cut_f(x, mode, 1) for x in rargs[0]],
                 [cut_f(x, mode, 3 if mode == "f32" else 2)
                  for x in rargs[1]], *rargs[2:])
        e_k = float(tr.tile_energy_resident(*rargs, mode=mode))
        e_p = float(tr.tile_energy_resident_reference(*rargs, mode=mode))
        err = abs(e_k - e_p)
        if not err <= RTOL_TILE_FP32 * abs(e_p):
            raise RuntimeError(f"resident {mode} tile: kernel {e_k!r} vs "
                               f"plain {e_p!r}")
        ms_rk = cuda_ms(torch, lambda: tr.tile_energy_resident(
            *rargs, mode=mode), 10)
        ms_rp = cuda_ms(torch, lambda: tr.tile_energy_resident_reference(
            *rargs, mode=mode), 3)
        ms_path = cuda_ms(torch, resident_path, 10)
        ms_cut = cuda_ms(torch, lambda: tr.tile_energy_resident(
            *cargs, mode=mode), 10)
        ms_w1 = ms_rk - ms_cut
        nmma = 3 if mode == "split" else 1
        flops = ({"fp32": w1_flops} if mode == "f32"
                 else {"bf16": nmma * w1_flops})
        flops["fp32"] = flops.get("fp32", 0) + 2 * 6 * ncell * NOCC ** 4
        bnd = bound_ms(nbytes(rargs) + 8 * TILE ** 3, flops)
        res[mode] = dict(e=e_k, err=err, ms=ms_rk, plain_ms=ms_rp,
                         bound=bnd)
        say(5, f"bench tile {mode} ok", shape=f"o={NOCC},T={TILE},"
            f"nvir={NVIR}", e_kernel=repr(e_k), e_plain=repr(e_p),
            e_fp64_plain_f32=repr(e_r64),
            rel_err_vs_fp64=f"{abs(e_k - e_r64) / abs(e_r64):.3e}",
            abs_err=f"{err:.3e}", rtol=RTOL_TILE_FP32,
            kernel_ms=f"{ms_rk:.4f}", plain_ms=f"{ms_rp:.3f}",
            path_ms=f"{ms_path:.4f}", cut_f=kc,
            kernel_ms_cut=f"{ms_cut:.4f}", w1_ms=f"{ms_w1:.4f}",
            w1_tflops=f"{w1_flops / ms_w1 / 1e9:.1f}",
            w1_mma_tflops=f"{nmma * w1_flops / ms_w1 / 1e9:.1f}",
            t2_split_ms=f"{split_ms:.3f}",
            stages=tr._lib().triples_resident_stages(NOCC, 4,
                                                     tr.MODES[mode]),
            bound_ms=f"{bnd[0]:.3f}", bound_by=bnd[1])
        say(5, f"trace {mode} path", top=json.dumps(
            trace_top(torch, resident_path, 5)))
        if mode != "f32":
            hl = bigr["t2T_w1"]
            say(5, f"t2 {mode} operand", gib=f"{nbytes(hl) / 2**30:.3f}",
                t2T_fp32_gib=f"{nbytes(bigr['t2T']) / 2**30:.3f}")
        del bigr, prep_r, out, rargs, cargs, resident_path
    ms_fpath = cuda_ms(torch, fused_path, 10)
    say(5, "bench tile fused path (W1 GEMMs + epilogue kernel)",
        path_ms=f"{ms_fpath:.3f}", epilogue_kernel_ms=f"{ms_k:.3f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    say(5, "trace fused path", top=json.dumps(
        trace_top(torch, fused_path, 5)))
    del bigf, prep_f

    # (c) the pinned fp64 E(T) through the resident kernel
    tr.launch_count = 0
    e_t = ccsd_t.kernel(tilt.t1, tilt.t2, tilt.eris, tile=8,
                        engine="resident")
    nl = tr.launch_count
    d_t = e_t - E_T_TILT
    if not (abs(d_t) < 1e-9 and nl > 0):
        raise RuntimeError(f"resident E(T) {e_t!r} off the pin by {d_t} "
                           f"({nl} kernel launches)")
    say(5, "pinned fp64 ok", e_t=repr(e_t), e_t_err=f"{d_t:.2e}",
        kernel_launches=nl)

    # (d) the 64-tile probe through engine='resident', beside the fused
    # probe (fused, resident f32, split through engine='auto', bf16, fused
    # again)
    e_f32, pms_f32, f32_launches = probe("resident", tr)
    e_split, pms_split, res_launches = probe("auto", tr, dot_precision="high")
    e_bf16, pms_bf16, bf16_launches = probe("resident", tr,
                                            dot_precision="default")
    e_fused2, probe_ms2, _ = probe("fused", tc)
    d_fused = abs(e_f32 - e_probe) / abs(e_probe)
    d_split = abs(e_split - e_f32) / abs(e_f32)
    if not (d_fused <= RTOL_TILE_FP32 and d_split <= RTOL_SPLIT
            and min(f32_launches, res_launches, bf16_launches) > 0):
        raise RuntimeError(f"resident probe: f32 {e_f32!r}, split "
                           f"{e_split!r}, fused {e_probe!r}, launches "
                           f"{f32_launches} {res_launches} {bf16_launches}")
    say(5, "(T) probe", tiles=NPROBE, launches=res_launches,
        ms_per_tile_f32=f"{pms_f32:.3f}", ms_per_tile_split=f"{pms_split:.3f}",
        ms_per_tile_bf16=f"{pms_bf16:.3f}",
        ms_per_tile_fused=f"{probe_ms:.3f} {probe_ms2:.3f}",
        e_f32=repr(e_f32), e_split=repr(e_split), e_bf16=repr(e_bf16),
        e_fused=repr(e_probe),
        rel_f32_vs_fused=f"{d_fused:.3e}", rtol=RTOL_TILE_FP32,
        rel_split_vs_f32=f"{d_split:.3e}", rtol_split=RTOL_SPLIT,
        rel_bf16_vs_f32=f"{abs(e_bf16 - e_f32) / abs(e_f32):.3e}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)),
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")

    say(5, "done", seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()

    # ---- phase 6: the (T) design probes ----------------------------------
    # (a) the probes' entry points at the JAX scripts' shapes, each raising
    # if its value is off its closed form; the counts are read just after
    for k in pv.launch_count:
        pv.launch_count[k] = 0
    sp.launch_count = 0
    r1 = pv.p1_dispatch(dev)
    r2 = pv.p2_smem(dev)["cap"]
    r3 = pv.p3_dots(dev)
    r4 = pv.p4_stream(dev)["fetch"]
    r5 = sp.main(dev)
    probe_launches = dict(pv.launch_count, slab=sp.launch_count)
    if not all(probe_launches.values()):
        raise RuntimeError(f"a probe kernel was not launched: "
                           f"{probe_launches}")
    if r2["cap"] != r2["optin"]:
        raise RuntimeError(f"smem cap {r2['cap']} != optin {r2['optin']}")
    say(6, "probe entry points ok", launches=json.dumps(probe_launches),
        smem_cap=r2["cap"], smem_optin=r2["optin"],
        smem_blocks_per_sm=r2["blocks_per_sm"],
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))

    # (b) each kernel against its plain version on seeded random inputs;
    # the times of the plain versions and the library calls come from the
    # probes' own timer (pv.cuda_ms), which keeps the host's launch gaps out
    # of the span, as the probes' kernel times do
    gen6 = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape):
        return torch.rand(shape, generator=gen6, device=dev) * 2 - 1

    # the launch floor: the empty kernel's graph-replayed time of (a); every
    # probe's bound is the largest of its bytes, its operations and it
    floor = r1[str((pv.T,))]["ms_graph"]

    def probe_bound(nbyte, flops):
        b = bound_ms(nbyte, flops)
        return (floor, "launch") if floor > b[0] else b

    rec = {}
    x = rand(1, 1)
    for grid in ((pv.T,), (pv.T, pv.T)):
        if not torch.equal(pv.dispatch(x, grid), pv.dispatch_reference(x)):
            raise RuntimeError(f"dispatch grid={grid} differs from plain")
    # rows 4 and 5 time the kernel and its plain version alike: NCHAIN
    # calls replayed from a CUDA graph (pv.graph_ms), as the floor is
    g1 = r1[str((pv.T,))]
    rec["dispatch"] = dict(
        err=0.0, ms=g1["ms_graph"],
        plain_ms=pv.graph_ms(lambda: pv.dispatch_reference(x), dev),
        bound=probe_bound(2 * 4, {}), library=None)
    g2 = r1[str((pv.T, pv.T))]
    say(6, "p1 dispatch ok (exact)",
        ms_stream_graph_grid_T=f"{g1['ms']:.5f}/{g1['ms_graph']:.5f}",
        ms_stream_graph_grid_TxT=f"{g2['ms']:.5f}/{g2['ms_graph']:.5f}",
        plain_ms_stream=f"{pv.cuda_ms(lambda: pv.dispatch_reference(x),
                                      64, dev):.5f}",
        plain_ms=f"{rec['dispatch']['plain_ms']:.5f}",
        bound_ms=f"{rec['dispatch']['bound'][0]:.5f}",
        bound_by=rec["dispatch"]["bound"][1])

    x = rand(8, pv.OO)
    if not torch.equal(pv.smem_copy(x, r2["cap"]), pv.smem_copy_reference(x)):
        raise RuntimeError("smem kernel differs from plain")
    # the size attribute set once (ms_graph); ms sets it at every launch
    rec["smem"] = dict(
        err=0.0, ms=r2["ms_graph"],
        plain_ms=pv.graph_ms(lambda: pv.smem_copy_reference(x), dev),
        bound=probe_bound(4 * pv.OO + 4, {}), library=None)
    say(6, "p2 smem ok (exact)", cap_bytes=r2["cap"],
        ms_stream_attr_each_launch=f"{r2['ms']:.5f}",
        ms_graph=f"{r2['ms_graph']:.5f}",
        share_of_bound=f"{rec['smem']['bound'][0] / r2['ms_graph']:.3f}",
        plain_ms_stream=f"{pv.cuda_ms(lambda: pv.smem_copy_reference(x),
                                      20, dev):.5f}",
        plain_ms=f"{rec['smem']['plain_ms']:.5f}",
        bound_ms=f"{rec['smem']['bound'][0]:.5f}",
        bound_by=rec["smem"]["bound"][1])

    # p3: the kernel's times (r3) are on operands made beforehand, and so
    # are the library calls': bf16 for 'bf16', the K-tripled bf16 pair
    # [a_hi | a_hi | a_lo] (M x 3K) . [b_hi; b_lo; b_hi] (3K x N) for
    # 'split' (one matmul, fp32 accumulation), fp32 for 'f32'; the split
    # pass (or a's transpose in 'f32') is timed apart
    reps = pv.REPS * pv.T
    err3 = 0.0
    for (M, K, N, tag) in pv.p3_shapes():
        a, b = rand(M, K), rand(K, N)
        (ah, al), (bh, bl) = tr.hilo(a), tr.hilo(b)
        a3 = torch.cat([ah, ah, al], 1)
        b3 = torch.cat([bh, bl, bh], 0)
        lib_ms = {
            "f32": pv.cuda_ms(lambda: [a @ b for _ in range(reps)], 3, dev),
            "bf16": pv.cuda_ms(lambda: [ah @ bh for _ in range(reps)], 3,
                               dev),
            "split": pv.cuda_ms(lambda: [a3 @ b3 for _ in range(reps)], 3,
                                dev)}
        del a3, b3
        for mode in ("bf16", "split", "f32"):
            out, cs = pv.dots(a, b, mode, reps)
            ref, rcs = pv.dots_reference(a, b, mode, reps)
            torch.cuda.synchronize()
            scale = ref.abs().max().item()
            torch.testing.assert_close(out, ref, rtol=RTOL_DOTS,
                                       atol=RTOL_DOTS * scale)
            torch.testing.assert_close(
                cs, rcs, rtol=RTOL_DOTS,
                atol=RTOL_DOTS * rcs.abs().max().item())
            err = (out - ref).abs().max().item()
            err3 = max(err3, err)
            fl = 2.0 * M * K * N * reps
            bnd = probe_bound((M * K + K * N + M * pv.OUT_COLS) * 4
                              + cs.numel() * 8,
                              {"fp32": fl} if mode == "f32" else
                              {"bf16": fl * (3 if mode == "split" else 1)})
            plain = pv.cuda_ms(
                lambda: pv.dots_reference(a, b, mode, reps), 3, dev)
            r = r3[f"{tag}/{mode}"]
            lib = lib_ms[mode]
            if tag == "A" and mode == "bf16":
                rec["dots"] = dict(err=err3, ms=r["ms"], plain_ms=plain,
                                   bound=bnd, library=lib)
            feed = {} if r["feed_ms"] is None else dict(
                copy_only_ms=f"{r['feed_ms']:.4f}",
                copy_only_tbs=f"{r['feed_rate']:.2f}")
            say(6, f"p3 dots {tag} {mode} ok", shape=f"({M}x{K})x({K}x{N})",
                reps=reps, abs_err=f"{err:.2e}", scale=f"{scale:.3e}",
                rtol=RTOL_DOTS, ms=f"{r['ms']:.4f}",
                tflops=f"{r['rate']:.1f}", library_ms=f"{lib:.4f}",
                bound_ms=f"{bnd[0]:.4f}", bound_by=bnd[1],
                split_pass_ms=f"{r['split_ms']:.4f}",
                gb_streamed=f"{r['bytes_read'] / 1e9:.3f}",
                l2_tbs=f"{r['l2_rate']:.2f}", **feed,
                plain_ms=f"{plain:.4f}")
    rec["dots"]["err"] = err3

    t2r, ovr = (rand(*x.shape) for x in pv.p4_inputs(dev, f32))
    v_k, part = pv.stream_sum(t2r, ovr)
    v_p, tot = pv.stream_sum_reference(t2r, ovr)
    torch.cuda.synchronize()
    err4 = abs(part.sum().item() - tot.sum().item())
    if not (err4 <= RTOL_FP64 * abs(tot.sum().item())
            and abs(v_k.item() - v_p.item()) <= 1e-6 * abs(v_p.item())):
        raise RuntimeError(f"stream: {part.sum().item()!r} vs "
                           f"{tot.sum().item()!r}, value {v_k.item()!r} vs "
                           f"{v_p.item()!r}")
    flush = torch.empty(pv.FLUSH_BYTES // 4, device=dev)
    cold = dict(before=lambda: flush.sum())
    nsm = torch.cuda.get_device_properties(dev).multi_processor_count
    rec["stream"] = dict(
        err=err4, ms=r4["ms"],
        plain_ms=pv.cuda_ms(lambda: pv.stream_sum_reference(t2r, ovr), 10,
                            dev, **cold),
        bound=probe_bound(r4["bytes"] + 8 * 4 * nsm + 4, {}),
        library=pv.cuda_ms(lambda: t2r.sum() + ovr.sum(), 10, dev, **cold))
    del t2r, ovr
    say(6, "p4 stream ok", bytes=r4["bytes"], abs_err=f"{err4:.2e}",
        rtol=RTOL_FP64, ms_cold=f"{r4['ms']:.4f}",
        gbs_cold=f"{r4['rate']:.0f}", ms_warm=f"{r4['ms_warm']:.4f}",
        gbs_warm=f"{r4['rate_warm']:.0f}",
        bound_ms=f"{rec['stream']['bound'][0]:.4f}",
        plain_ms_cold=f"{rec['stream']['plain_ms']:.4f}",
        library_ms_cold=f"{rec['stream']['library']:.4f}")

    # the slab relayout: kernel and permute().contiguous(), cold (L2
    # flushed before each launch) and warm
    w = rand(sp.T, sp.o, sp.T, sp.o * sp.o)
    out = sp.relayout(w)
    w5 = w.view(sp.T, sp.o, sp.T, sp.o, sp.o)
    if not (torch.equal(out, sp.relayout_reference(w)) and torch.equal(
            sp.probe_value(out), w5[0, 0, 0, 0, 0] + w5[1, 1, 1, 1, 1])):
        raise RuntimeError("slab relayout differs from plain")

    def permute():
        return w5.permute(0, 2, 3, 1, 4).contiguous()

    rec["slab"] = dict(
        err=0.0, ms=r5["ms"],
        plain_ms=pv.cuda_ms(lambda: sp.relayout_reference(w), 20, dev,
                            **cold),
        bound=probe_bound(r5["bytes"], {}),
        library=pv.cuda_ms(permute, 20, dev, **cold))
    lib_warm = pv.cuda_ms(permute, 20, dev)
    # the floor of the cold timing: the empty kernel, timed as the slab is
    x = rand(1, 1)
    empty_cold = pv.cuda_ms(lambda: pv.dispatch(x, (pv.T,)), 20, dev, **cold)
    del w, out, w5, flush
    say(6, "slab relayout ok (bitwise)", bytes=r5["bytes"],
        ms_cold=f"{r5['ms']:.5f}", ms_warm=f"{r5['ms_warm']:.5f}",
        gbs_cold=f"{r5['rate']:.0f}",
        bound_ms=f"{rec['slab']['bound'][0]:.5f}",
        bound_by=rec["slab"]["bound"][1],
        share_of_bound_cold=f"{rec['slab']['bound'][0] / r5['ms']:.3f}",
        plain_ms_cold=f"{rec['slab']['plain_ms']:.5f}",
        library_ms_cold=f"{rec['slab']['library']:.5f}",
        library_ms_warm=f"{lib_warm:.5f}",
        empty_kernel_ms_cold=f"{empty_cold:.5f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))

    say(6, "done", seconds=f"{time.perf_counter() - t_phase:.1f}")
    t_phase = time.perf_counter()

    # ---- phase 7: Lambda, certification, RDMs, device DIIS ---------------
    # (a) H2O/cc-pVDZ in fp64, phase 2's CCSD tightened by a warm restart
    # so the RDM energy identity is not limited by the amplitudes' residual
    n_tc, n_tr = tc.launch_count, tr.launch_count
    t0 = time.perf_counter()
    cc.set(conv_tol=1e-12, conv_tol_normt=1e-10).kernel(t1=cc.t1, t2=cc.t2)
    l1h, l2h = cc.solve_lambda()
    cl, l1d, l2d = lambda_ad.kernel(cc.t1, cc.t2, cc.eris, conv_tol=1e-10,
                                    max_cycle=100, diis_backend="device")
    dl = max(float((l1h - l1d).abs().max()), float((l2h - l2d).abs().max()))
    if not (cc.converged and cl and dl < ATOL_LAMBDA):
        raise RuntimeError(f"Lambda host vs device ring: max |dl| {dl} "
                           f"(converged {cc.converged} {cl})")
    say(7, "lambda host vs device ring ok", dtype="float64",
        max_abs_dl=f"{dl:.2e}", atol=ATOL_LAMBDA,
        seconds=f"{time.perf_counter() - t0:.1f}")
    rdm1, rdm2 = cc.make_rdm12()
    mo = torch.as_tensor(cc.mo_coeff, dtype=f64, device=dev)
    h_mo = mo.T @ torch.as_tensor(cc._scf.get_hcore(), dtype=f64,
                                  device=dev) @ mo
    g_mo = ao2mo.full(torch.as_tensor(cc._eri_ao, dtype=f64, device=dev), mo)
    e_rdm = float(torch.einsum("pq,pq->", h_mo, rdm1)
                  + 0.5 * torch.einsum("pqrs,pqrs->", g_mo, rdm2)) \
        + cc._scf.e_nuc
    occ = torch.linalg.eigvalsh(rdm1)
    d_tr, d_e = float(torch.trace(rdm1)) - 10.0, e_rdm - cc.e_tot
    if not (abs(d_tr) < ATOL_RDM and abs(d_e) < ATOL_RDM
            and float(occ.min()) > -1e-8 and float(occ.max()) < 2 + 1e-8):
        raise RuntimeError(f"RDM identities: tr-10 {d_tr}, E-E_tot {d_e}, "
                           f"occupations [{occ.min()}, {occ.max()}]")
    say(7, "rdm identities ok", trace_err=f"{d_tr:.2e}",
        energy_err=f"{d_e:.2e}", atol=ATOL_RDM,
        occupations=f"[{float(occ.min()):.3e}, {float(occ.max()):.6f}]")
    del rdm2, g_mo

    # (b) certification: CCSD and Lambda in fp32, E_L in fp64, at the
    # driver's tolerances and stopped early
    t0 = time.perf_counter()
    gaps, e_cert = {}, {}
    for name, kw in (("converged", {}), ("early", CERT_EARLY)):
        c32 = CCSD(cc._scf, device=dev, dtype=f32).set(**kw).run()
        l1_32, l2_32 = c32.solve_lambda()
        t64 = [c32.t1.double(), c32.t2.double()]
        e_cert[name] = e_l = float(lambda_ad.lagrangian_energy(
            *t64, l1_32.double(), l2_32.double(), cc.eris))
        e_unc = float(rccsd.energy(*t64, cc.eris))
        if not c32.converged:
            raise RuntimeError(f"fp32 CCSD ({name}) did not converge")
        gaps[name] = [abs(e - cc.e_corr) for e in (c32.e_corr, e_unc, e_l)]
        del c32, l1_32, l2_32, t64
    raw, unc, cert = gaps["converged"]
    _, unc_early, cert_early = gaps["early"]
    if not (cert < ATOL_CERTIFIED and cert_early * CERT_GAIN < unc_early):
        raise RuntimeError(f"certified fp32 energy vs fp64: gaps (raw, "
                           f"uncertified, certified) {gaps}")
    say(7, "certification ok", e_fp64=repr(cc.e_corr),
        e_certified=repr(e_cert["converged"]), raw_fp32_gap=f"{raw:.3e}",
        uncertified_gap=f"{unc:.3e}", certified_gap=f"{cert:.3e}",
        atol=ATOL_CERTIFIED, early_uncertified_gap=f"{unc_early:.3e}",
        early_certified_gap=f"{cert_early:.3e}", min_gain=CERT_GAIN,
        seconds=f"{time.perf_counter() - t0:.1f}")

    # (c) the (H2O)8 shape in fp32: two Lambda cycles with the device ring
    ntile_l = memory.plan_ladder_ntile(NOCC, NVIR, NAUX, f32, vjp=True,
                                       device=dev)
    n_ring = NOCC * NVIR + bt2.numel()
    torch.cuda.reset_peak_memory_stats()
    (_, lb1, lb2), sec_l = seconds(torch, lambda: lambda_ad.kernel(
        bt1, bt2, beris, max_cycle=2, ntile=ntile_l, diis_backend="device"))
    peak_l = torch.cuda.max_memory_allocated()
    if not (torch.isfinite(lb1).all() and torch.isfinite(lb2).all()):
        raise RuntimeError("non-finite Lambda multipliers at the (H2O)8 shape")
    say(7, "(H2O)8 lambda fp32 device ring", ntile=ntile_l, cycles=2,
        sec_per_cycle=f"{sec_l / 2:.3f}",
        sweeps_per_cycle=f"{sec_l / 2 / sec:.2f}",
        peak_gib=f"{peak_l / 2**30:.2f}",
        ring_gib=f"{2 * 6 * n_ring * 4 / 2**30:.2f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    del lb1, lb2
    # the solver's first step (l = t, the MP2 amplitudes: the synthetic
    # integrals are not a molecule's, and their iterates grow without
    # bound) in fp32 against the same step in fp64
    s32, sec_s32 = seconds(torch, lambda: lambda_ad._lambda_step(
        bt1, bt2, bt1, bt2, beris, ntile=ntile_l))
    r2_32 = s32[3]
    del s32
    e64 = RERIs(*(None if x is None else x.double() for x in beris))
    t64 = [bt1.double(), bt2.double()]
    ntile_l64 = memory.plan_ladder_ntile(NOCC, NVIR, NAUX, f64, vjp=True,
                                         device=dev)
    torch.cuda.reset_peak_memory_stats()
    s64, sec_s64 = seconds(torch, lambda: lambda_ad._lambda_step(
        *t64, *t64, e64, ntile=ntile_l64))
    peak_s64 = torch.cuda.max_memory_allocated()
    rel = float(torch.linalg.norm(r2_32.double() - s64[3])
                / torch.linalg.norm(s64[3]))
    res2_max = float(s64[3].abs().max())
    del s64, r2_32
    if not rel < RTOL_SWEEP_FP32:
        raise RuntimeError(f"fp32 Lambda step deviates from fp64 by {rel}")
    say(7, "fp32 vs fp64 lambda step ok", rel_res2_diff=f"{rel:.3e}",
        rtol=RTOL_SWEEP_FP32, res2_max=f"{res2_max:.3e}",
        sec_fp32=f"{sec_s32:.3f}", sec_fp64=f"{sec_s64:.3f}",
        ntile_fp64=ntile_l64, peak_gib_fp64=f"{peak_s64 / 2**30:.2f}")
    # one fp64 Lagrangian energy at the same (t, l), the certification at
    # this shape
    torch.cuda.reset_peak_memory_stats()
    ntile64 = memory.plan_ladder_ntile(NOCC, NVIR, NAUX, f64, device=dev)
    e_lag, sec_lag = seconds(torch, lambda: float(lambda_ad.lagrangian_energy(
        *t64, *t64, e64, ntile=ntile64)))
    if not (e_lag == e_lag and abs(e_lag) < float("inf")):
        raise RuntimeError(f"non-finite Lagrangian energy {e_lag}")
    say(7, "(H2O)8 lagrangian energy fp64", e_l=repr(e_lag),
        sec=f"{sec_lag:.3f}", ntile=ntile64,
        peak_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}")
    del e64, t64
    # two CCSD cycles with the host ring, then the device ring: the
    # difference is the host ring's copies and its NumPy DIIS.  The level
    # shift damps the step (the same sweep, denominators larger by it) so
    # that the synthetic integrals' iterates stay finite (undamped, the
    # residual at the MP2 amplitudes is ~1e7 against t2 ~ 0.2, and after
    # two cycles the host ring's fp32 Gram overflows); the ring's work
    # does not depend on the values
    import numpy as np
    from pyscf_mpcc_tpu_torch.lib.diis import DIIS
    diis_sec, e2c, growth, shift, hdiis = {}, {}, {}, 1e9, DIIS(space=6)
    for backend in ("host", "device"):
        (_, e, c1, c2), s2c = seconds(torch, lambda: rccsd.kernel(
            beris, max_cycle=2, ntile=ntile, t1=bt1, t2=bt2,
            level_shift=shift, diis_backend=backend,
            adiis=hdiis if backend == "host" else None))
        diis_sec[backend], e2c[backend] = s2c / 2, e
        growth[backend] = g = float(c2.abs().max() / bt2.abs().max())
        if not (torch.isfinite(c1).all() and torch.isfinite(c2).all()
                and abs(e) < float("inf") and g < 10):
            raise RuntimeError(f"{backend} ring: E {e}, t2 grew {g}")
        if backend == "host":
            h1, h2 = c1, c2
        del c1, c2
    # one more host-ring cycle's work on the host ring's last amplitudes,
    # step by step: device-to-host copy, concatenation, DIIS update (its
    # Gram apart) and the host-to-device copy back
    t0 = time.perf_counter()
    a, b = h1.cpu().numpy(), h2.cpu().numpy()
    t_d2h = time.perf_counter() - t0
    t0 = time.perf_counter()
    vec = np.concatenate([a.ravel(), b.ravel()])
    t_cat = time.perf_counter() - t0
    del a, b, h1, h2
    t0 = time.perf_counter()
    vec = hdiis.update(vec)
    t_upd = time.perf_counter() - t0
    nd = len(hdiis._errs)
    # the Gram work of an update: the newest error's dots (lib/diis keeps
    # the rest from the update before)
    t0 = time.perf_counter()
    for j in range(nd):
        np.dot(hdiis._errs[-1], hdiis._errs[j])
    t_gram = time.perf_counter() - t0
    t_h2d = seconds(torch, lambda: torch.from_numpy(vec).to(dev))[1]
    del vec, hdiis
    say(7, "(H2O)8 ccsd cycles host vs device ring", level_shift=shift,
        e_host=repr(e2c["host"]), e_device=repr(e2c["device"]),
        t2_growth_host=f"{growth['host']:.4f}",
        t2_growth_device=f"{growth['device']:.4f}",
        sec_per_cycle_host=f"{diis_sec['host']:.3f}",
        sec_per_cycle_device=f"{diis_sec['device']:.3f}",
        host_ring_sec=f"{diis_sec['host'] - diis_sec['device']:.3f}",
        clocks_after=json.dumps(nvidia_smi(CLOCKS)))
    say(7, "host ring cycle split", gb=f"{4 * n_ring / 1e9:.3f}",
        d2h_sec=f"{t_d2h:.3f}", concat_sec=f"{t_cat:.3f}",
        update_sec=f"{t_upd:.3f}", ring_vectors=nd,
        gram_sec=f"{t_gram:.3f}", gram_dots=nd,
        h2d_sec=f"{t_h2d:.3f}",
        sum_sec=f"{t_d2h + t_cat + t_upd + t_h2d:.3f}")

    # (d) the CCSD scanner: warm start at a second geometry against a cold
    # run there (fp64 on the card, frozen core)
    def ccsd_at(geom, **kw):
        mf = RHF(gto.M(atom=geom, basis="cc-pvdz", unit="angstrom"))
        mf.conv_tol = 1e-11
        mf.kernel()
        c = CCSD(mf, frozen=1, device=dev, dtype=f64)
        c.conv_tol = 1e-9
        c.kernel()
        return c

    g1 = "O 0 0 0.1173; H 0 0.7572 -0.4692; H 0 -0.7572 -0.4692"
    g2 = "O 0 0 0.1273; H 0 0.7672 -0.4692; H 0 -0.7672 -0.4692"
    scan = ccsd_at(g1).as_scanner()
    e_warm = scan(g2)
    e_cold = ccsd_at(g2).e_tot
    if not (scan.converged and abs(e_warm - e_cold) < ATOL_SCAN
            and scan.cc.device.type == "cuda" and scan.cc.dtype == f64):
        raise RuntimeError(f"scanner {e_warm!r} vs cold {e_cold!r}")
    say(7, "ccsd scanner ok", e_warm=repr(e_warm),
        d_cold=f"{e_warm - e_cold:.2e}", atol=ATOL_SCAN,
        kernel_launches=tc.launch_count - n_tc + tr.launch_count - n_tr)

    say(7, "done", seconds=f"{time.perf_counter() - t_phase:.1f}")

    # ---- phase 8: MP2 and MP-CC -----------------------------------------
    t0 = time.perf_counter()
    mpcc_phase(torch, smi, cc, beris, bt1, bt2, sec, ntile)
    say(8, "done", seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- phase 9: the open-shell path ---------------------------------
    del beris, bt1, bt2
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mf_oh = open_shell_phase(torch, smi, dev)
    say(9, "done", seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- phase 10: the open-shell MP-CC layer ----------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    umpcc_phase(torch, smi, dev, mf_oh)
    del mf_oh
    say(10, "done", seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- phase 11: the (T)-response and spin-orbital layer ---------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    so_launches = spinorb_phase(torch, smi, dev)
    # only the fp32 launches join the record's rows (see spinorb_phase)
    comb_launches += so_launches["fp32"]["fused"]
    c4_launches += so_launches["fp32"]["chunk"]
    res_launches += so_launches["fp32"]["resident"]
    say(11, "done", launches_fp32_in_record=json.dumps(so_launches["fp32"]),
        launches_fp64_not_in_record=json.dumps(so_launches["fp64"]),
        seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- phase 12: EOM, MOM-GF and the streamed ladder ------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eom_stream_phase(torch, smi, dev, sec)
    say(12, "done", seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- phase 13: the multi-device layer ------------------------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh_launches = run_ranks(mesh_bench, torch.cuda.device_count())
    comb_launches += mesh_launches["fused"]
    c4_launches += mesh_launches["chunk"]
    res_launches += mesh_launches["resident"]
    t1_ = time.perf_counter()
    gaps, shared_launches, backend = run_ranks(shared_card, 2)
    bad = {k: v for k, v in gaps.items() if not v <= ATOL_MESH_FP64}
    if bad or not all(shared_launches.values()):
        raise RuntimeError(f"two ranks on one card: {bad} "
                           f"{shared_launches}")
    say(13, "two ranks share the card", backend=backend, world_size=2,
        gaps=json.dumps({k: f"{v:.2e}" for k, v in gaps.items()}),
        atol=ATOL_MESH_FP64,
        launches_fp64_not_in_record=json.dumps(shared_launches),
        seconds=f"{time.perf_counter() - t1_:.1f}")
    say(13, "done", launches_in_record=json.dumps(mesh_launches),
        seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- phase 14: the (T) bf16 tiers on the fused engine ----------------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tier_launches = bf16_tier_phase(torch, smi, dev)
    comb_launches += tier_launches["fused"]
    c4_launches += tier_launches["chunk"]
    say(14, "done", launches_in_record=json.dumps(tier_launches),
        seconds=f"{time.perf_counter() - t0:.1f}")

    # ---- phase 15: the certified (H2O)8/cc-pVTZ campaign ----------------
    # its checkpoint goes to a directory of its own under .campaign/, which
    # phase 16 reads and which is removed after both
    os.makedirs(os.path.join(ROOT, ".campaign"), exist_ok=True)
    w8_scratch = tempfile.mkdtemp(prefix="chip_smoke_w8_",
                                  dir=os.path.join(ROOT, ".campaign"))
    try:
        t0 = time.perf_counter()
        w8_certify_phase(torch, smi, dev, w8_scratch)
        say(15, "done", seconds=f"{time.perf_counter() - t0:.1f}")

        # ---- phase 16: the full (H2O)8/cc-pVTZ (T) and the pipeline -----
        t0 = time.perf_counter()
        w8t_launches = w8_triples_phase(
            torch, smi, dev, w8_scratch,
            {"fused": probe_ms, "resident": pms_split})
        comb_launches += w8t_launches["fused"]
        res_launches += w8t_launches["resident"]
        say(16, "done", launches_in_record=json.dumps(w8t_launches),
            seconds=f"{time.perf_counter() - t0:.1f}")
    finally:
        shutil.rmtree(w8_scratch, ignore_errors=True)
        torch.cuda.empty_cache()

    # ---- phase 17: the benzene/cc-pVTZ campaign -------------------------
    # its checkpoint goes to a directory of its own under .campaign/,
    # removed after the phase
    bz_scratch = tempfile.mkdtemp(prefix="chip_smoke_benzene_",
                                  dir=os.path.join(ROOT, ".campaign"))
    try:
        t0 = time.perf_counter()
        bz_launches = benzene_phase(torch, smi, dev, bz_scratch)
        comb_launches += bz_launches
        say(17, "done", launches_in_record=bz_launches,
            seconds=f"{time.perf_counter() - t0:.1f}")
    finally:
        shutil.rmtree(bz_scratch, ignore_errors=True)
        torch.cuda.empty_cache()

    print(f"[chip_smoke] phases 0-17 done seconds="
          f"{time.perf_counter() - t_start:.1f}", flush=True)
    probe_src = "pyscf_mpcc_tpu_torch/ops/csrc/triples_probe.cu"
    probe_rows = [
        ("dispatch", probe_src, "tools/triples_probe_v6.py:53"),
        ("smem", probe_src, "tools/triples_probe_v6.py:79"),
        ("dots", probe_src, "tools/triples_probe_v6.py:123"),
        ("stream", probe_src, "tools/triples_probe_v6.py:154"),
        ("slab", "pyscf_mpcc_tpu_torch/ops/csrc/slab_relayout.cu",
         "tools/slab_loop_probe.py:39")]
    # the resident row: mode split, the mode that engine='auto' runs on
    # the resident kernel (dot_precision='high')
    rf = res["split"]
    print(json.dumps({"kernels": [{
        "name": "triples_combine", "route": "cuda",
        "source": "pyscf_mpcc_tpu_torch/ops/csrc/triples_combine.cu",
        "replaces": "pyscf_mpcc_tpu/ops/triples_combine.py:129",
        "launches": comb_launches, "max_abs_err": tile_err,
        "ms": ms_k, "plain_ms": ms_p, "bound_ms": comb_bound[0],
        "bound_by": comb_bound[1], "library_ms": None}, {
        "name": "triples_combine_chunk", "route": "cuda",
        "source": "pyscf_mpcc_tpu_torch/ops/csrc/triples_combine.cu",
        "replaces": "pyscf_mpcc_tpu/ops/triples_combine.py:561",
        "launches": c4_launches, "max_abs_err": chunk_err,
        "ms": chunk_ms, "plain_ms": chunk_plain_ms,
        "bound_ms": chunk_bound[0] / 4, "bound_by": chunk_bound[1],
        "library_ms": None}, {
        "name": "triples_resident", "route": "cuda",
        "source": "pyscf_mpcc_tpu_torch/ops/csrc/triples_resident.cu",
        "replaces": "pyscf_mpcc_tpu/ops/triples_resident.py:238",
        "launches": res_launches, "max_abs_err": rf["err"],
        "ms": rf["ms"], "plain_ms": rf["plain_ms"],
        "bound_ms": rf["bound"][0], "bound_by": rf["bound"][1],
        "library_ms": None}] + [{
        "name": f"probe_{name}", "route": "cuda", "source": src,
        "replaces": rep, "launches": probe_launches[name],
        "max_abs_err": rec[name]["err"], "ms": rec[name]["ms"],
        "plain_ms": rec[name]["plain_ms"], "bound_ms": rec[name]["bound"][0],
        "bound_by": rec[name]["bound"][1],
        "library_ms": rec[name]["library"]}
        for name, src, rep in probe_rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
