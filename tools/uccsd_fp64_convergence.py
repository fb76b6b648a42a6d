"""fp64 DF-UCCSD convergence of OH(H2O)3/cc-pVDZ, JAX package against the
PyTorch port, on the CPU and on identical integrals.

Both solvers start from MP2 amplitudes and run the host DIIS ring (space
6) for a fixed number of cycles with no stopping test, so that the
decay of |dt| (the norm of the step) and the drift of E_corr can be
read cycle by cycle.  The molecule, basis, aux basis and UHF tolerance
are those of examples/openshell_certify.py.

Run:  python tools/uccsd_fp64_convergence.py [--cycles 60] [--port]
Prints one 'CYCLE <solver> <it> <E_corr> <dE> <|dt|>' line a cycle and a
'SUMMARY <json>' line a solver.  --port also runs the port's solver
(slower on the CPU); without it only the JAX package's runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "examples"))


def scf_arrays():
    """(mo_a, mo_b, fa, fb, B, e_uhf, na, nb) of the converged DF-UHF."""
    from openshell_certify import build_mf
    mol, mf = build_mf()
    mf.with_df.build()
    mf.kernel()
    if not mf.converged:
        raise RuntimeError("UHF did not converge")
    dm = mf.make_rdm1()
    j, k = mf.get_jk(dm)
    h = mf.get_hcore()
    na, nb = mol.nelec
    return (np.asarray(mf.mo_coeff[0]), np.asarray(mf.mo_coeff[1]),
            np.asarray(h + j[0] + j[1] - k[0]),
            np.asarray(h + j[0] + j[1] - k[1]),
            np.asarray(mf.with_df.B_ao()), float(mf.e_tot), na, nb)


def run(name, update, energy, t1, t2, to_vec, from_vec, cycles):
    """Host-DIIS iteration of update; prints a CYCLE line each step."""
    from pyscf_mpcc_tpu.lib.diis import DIIS
    diis = DIIS(space=6)
    e_last = energy(t1, t2)
    rows = []
    t0 = time.perf_counter()
    for it in range(cycles):
        t1n, t2n = update(t1, t2)
        # |dt| as the solvers' kernels log it: the sum of the blocks' norms
        normt = sum(float(np.linalg.norm(np.asarray(x) - np.asarray(y)))
                    for x, y in zip((*t1n, *t2n), (*t1, *t2)))
        t1, t2 = from_vec(diis.update(to_vec(t1n, t2n)))
        e = energy(t1, t2)
        rows.append((it, e, e - e_last, normt))
        print(f"CYCLE {name} {it:2d} {e:.14f} {e - e_last:10.3e} "
              f"{normt:9.3e}", flush=True)
        e_last = e
    print("SUMMARY " + json.dumps(dict(
        solver=name, cycles=cycles, e_corr=rows[-1][1], last_de=rows[-1][2],
        last_normt=rows[-1][3], min_normt=min(r[3] for r in rows),
        e_drift_last_half=rows[-1][1] - rows[cycles // 2][1],
        seconds=round(time.perf_counter() - t0, 1))), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cycles", type=int, default=60)
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from pyscf_mpcc_tpu.cc import uccsd as ju

    mo_a, mo_b, fa, fb, B, e_uhf, na, nb = scf_arrays()
    print(f"E(DF-UHF) {e_uhf!r} nelec ({na}, {nb}) nao {mo_a.shape[0]} "
          f"naux {B.shape[0]}", flush=True)

    er = ju.make_eris_df(B, mo_a, mo_b, fa, fb, na, nb, dtype=jnp.float64)
    _, t1, t2 = ju.init_amps(er)
    shapes = [x.shape for x in (*t1, *t2)]
    run("jax", lambda a, b: ju.update_amps(a, b, er),
        lambda a, b: float(ju.energy(a, b, er)), t1, t2,
        lambda a, b: np.asarray(ju.amplitudes_to_vector(a, b)),
        lambda v: ju.vector_to_amplitudes(jnp.asarray(v), shapes),
        args.cycles)

    if args.port:
        import torch
        from pyscf_mpcc_tpu_torch.cc import uccsd as tu
        cpu = torch.device("cpu")
        pe = tu.make_eris_df(B, mo_a, mo_b, fa, fb, na, nb,
                             dtype=torch.float64, device=cpu)
        _, p1, p2 = tu.init_amps(pe)
        run("port", lambda a, b: tu.update_amps(a, b, pe),
            lambda a, b: float(tu.energy(a, b, pe)), p1, p2,
            lambda a, b: tu.amplitudes_to_vector(a, b).numpy(),
            lambda v: tu.vector_to_amplitudes(torch.from_numpy(v), shapes),
            args.cycles)


if __name__ == "__main__":
    main()
