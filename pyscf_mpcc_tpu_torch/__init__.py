"""pyscf_mpcc_tpu_torch — the PyTorch / CUDA port of pyscf_mpcc_tpu.

The JAX package ``pyscf_mpcc_tpu`` is the reference; this package keeps its
module layout and public function names so each module's counterpart is
easy to find:

- ``scf``           host NumPy RHF, UHF, ROHF and the energy-DIIS schemes
                    (copies of the JAX package's; its ``scf`` package
                    cannot be imported without jax),
- ``ao2mo``         AO -> MO quarter transforms on tensors,
- ``cc.eris``       MO integral containers (incore and density-fitted),
- ``cc.rccsd``      closed-shell CCSD sweep and the host-DIIS solver,
- ``cc.ccsd_t``     perturbative triples, through ``ops.triples_combine``
                    (engine 'fused') or ``ops.triples_resident`` ('resident'),
- ``cc.uccsd``, ``cc.uccsd_t``  open-shell CCSD over spin-traced blocks
                    (``cc.spinsum``) and its (T) correction,
- ``cc.driver``     the ``CCSD(mf)`` facade, restricted or unrestricted
                    by the mean field (on the CUDA device unless
                    ``device=torch.device('cpu')`` is passed),
- ``mp``            MP2, closed shell (canonical, SCS, DF, the
                    non-canonical iterative solver) and unrestricted
                    (``ump2``), and DF-MP2 with relaxed densities
                    (``DFRMP2``, ``SCSDFRMP2``, ``DFUMP2``),
- ``mpcc``          the restricted MP-CC hybrid: block masks, the masked
                    CCSD solver, the DF low-level solver, the fragmented
                    workflow and the ``MPCC(mf)`` facade,
- ``lo``            Pipek-Mezey localization (host NumPy copy),
- ``ops``           hand-written CUDA kernels for Hopper (sm_90a) and
                    their plain PyTorch versions,
- ``lib``           device/dtype policy, the memory planner, and the
                    host layers below.

The framework-free host layers (``gto`` with its native integral engine
and basis library, ``df``, ``lib.diis``, ``lib.logger``, ``lib.stream``,
``config``, ``lo.pm``, ``mpcc.masks``, ``scf``) are copies of the JAX package's, with their imports pointed
here: the port imports nothing of ``pyscf_mpcc_tpu`` and nothing of jax.
"""

__version__ = "0.1.0"

from pyscf_mpcc_tpu_torch import gto  # noqa: E402,F401


def M(**kwargs):
    """Build a molecule: ``pyscf_mpcc_tpu_torch.M(atom=..., basis=...)``."""
    return gto.M(**kwargs)
