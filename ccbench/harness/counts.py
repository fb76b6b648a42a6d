"""Frozen operation and byte counts, and the least time they allow.

Computed from the shapes (nocc, nvir, naux) alone, never from the program,
so a roofline share reads the same work whatever implements it.  Each count
is of the work the mathematics needs:

- the CCSD sweep with the particle-particle ladder's pair symmetry: half of
  the dense ladder (the ntile -> infinity limit of the pair-tiled count);
- the (T) energy over the restricted a > b > c triples it needs;
- bytes: each input read once and each output written once.

The least time is the larger of operations over the card's highest dense
rate (bf16) and bytes over its memory bandwidth (peaks.py), so no
implementation that passes the correctness check can read above 100 %.
"""

from __future__ import annotations

from ccbench.harness import peaks


def sweep_flops(nocc, nvir, naux):
    """Operations of one DF-CCSD update (cc/rccsd.update_amps' equations).

    Ladder: W = Ld^T Ld and tau * W over virtual pairs a >= b only (W and
    tau are pair symmetric), 2 * naux * nv^4 / 2 and 2 * no^2 * nv^4 / 2.
    The rest as the dense count: the ovvv-free factorized terms, the
    dressing, the four ring builds and four ring contractions, the Woooo
    build and use, and the Fock / L closures."""
    no, nv = nocc, nvir
    fl = naux * nv**4 + no**2 * nv**4
    fl += 2.0 * naux * no**2 * nv**2 * 6
    fl += 2.0 * naux * no * nv**2 * 4
    fl += 2.0 * no**3 * nv**3 * 8
    fl += 2.0 * no**4 * nv**2 * 3
    fl += 2.0 * no**3 * nv**2 * 6 + 2.0 * no**2 * nv**3 * 2
    return float(fl)


def sweep_bytes(nocc, nvir, naux, itemsize=4):
    """Bytes of one update: Lvv, Lov, Loo, the ovov, oovv, ovoo and oooo
    blocks, the Fock matrix, t1 and t2 read once; t1 and t2 written once."""
    no, nv = nocc, nvir
    n = naux * (nv * nv + no * nv + no * no)
    n += 2 * no * no * nv * nv + no**3 * nv + no**4
    n += (no + nv) ** 2
    n += 2 * (no * nv + no * no * nv * nv)
    return float(n * itemsize)


def triples_flops(nocc, nvir):
    """Operations of one (T) energy: for each of the nvir (nvir-1)
    (nvir-2) / 6 triples a > b > c, the six permutations of the connected
    W, each a contraction over one virtual (2 nocc^3 nvir) and one occupied
    (2 nocc^4) index.  The disconnected V, the r3 combination and the
    energy sum are left out, so the count is a lower bound."""
    no, nv = nocc, nvir
    ntrip = nv * (nv - 1) * (nv - 2) // 6
    return float(ntrip * 6 * (2.0 * no**3 * nv + 2.0 * no**4))


def triples_bytes(nocc, nvir, naux, itemsize=4):
    """Bytes of one (T) energy: t1, t2, ovov, ovoo, Lov, Lvv and the Fock
    diagonal read once; one energy written."""
    no, nv = nocc, nvir
    n = no * nv + 2 * no * no * nv * nv + no**3 * nv
    n += naux * (no * nv + nv * nv) + no + nv
    return float(n * itemsize + 8)


def least_time(flops, nbytes):
    """Seconds the card needs at least: max(flops / peak rate, bytes /
    bandwidth)."""
    return max(flops / peaks.DENSE_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
