"""The port's copies of the JAX package's host layers (gto, df, lib.diis,
lib.chkfile, lib.logger, lib.stream, config, lo.pm, lo.avas, mpcc.masks,
scf.diis, and the spin-orbital layer cc.addons, scf.ghf, cc.gccsd_slow,
ci.fci_slow, cc.eom_slow, cc.gccsdt1_slow, cc.gccsdt_slow, mp.mp2f12)
against the originals.

The port imports nothing of pyscf_mpcc_tpu, so it carries these NumPy/C++
layers itself; they must stay the same functions.  On H2O/cc-pVDZ the
integrals, the DF factor, a DIIS extrapolation, the Lowdin populations and
a Pipek-Mezey localization, the AVAS selection, EDIIS/ADIIS extrapolations agree to 1e-12 (the same code on the same
inputs; only the native engine's thread order may move the last bits), a
chk file written by either chkfile loads bit for bit in the other, the
MP-CC block masks are identical arrays, and the vendored basis library is
byte-identical.  The spin-orbital layer's eight copies are the originals'
source with the package name in their imports changed and a line added to
their docstrings; on linear H4/sto-3g the spin-orbital integrals, the
spin-orbital CCSD, FCI, the EOM Hamiltonian, CCSDT-1 and CCSDT agree to
1e-12 (GHF and MP2-F12 are held to the originals in test_torch_ghf.py and
test_torch_mp2f12.py).
"""

import filecmp
import os

import numpy as np
import pytest

from pyscf_mpcc_tpu import config as jconfig
from pyscf_mpcc_tpu import df as jdf
from pyscf_mpcc_tpu import gto as jgto
from pyscf_mpcc_tpu.lib import chkfile as jchkfile
from pyscf_mpcc_tpu.lib import diis as jdiis
from pyscf_mpcc_tpu.lo.avas import avas as javas
from pyscf_mpcc_tpu.lo import pm as jpm
from pyscf_mpcc_tpu.mpcc import masks as jmasks
from pyscf_mpcc_tpu.scf import diis as jscf_diis
from pyscf_mpcc_tpu_torch import config, df, gto
from pyscf_mpcc_tpu_torch.gto import native
from pyscf_mpcc_tpu_torch.lib import chkfile, diis, logger, stream
from pyscf_mpcc_tpu_torch import lo
from pyscf_mpcc_tpu_torch.lo import pm
from pyscf_mpcc_tpu_torch.lo.avas import avas
from pyscf_mpcc_tpu_torch.mpcc import masks
from pyscf_mpcc_tpu_torch.scf import diis as scf_diis

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOM = [[8, (0., 0., 0.)], [1, (0., -0.757, 0.587)],
        [1, (0., 0.757, 0.587)]]
TOL = 1e-12


@pytest.fixture(scope="module")
def mols():
    return (gto.M(atom=ATOM, basis="cc-pvdz"),
            jgto.M(atom=ATOM, basis="cc-pvdz"))


INTEGRALS = {
    "ovlp": lambda g, m: g.intor_ovlp(m),
    "kin": lambda g, m: g.intor_kin(m),
    "hcore": lambda g, m: g.intor_kin(m) + g.intor_nuc(m),
    "eri": lambda g, m: g.intor_eri(m),
}


@pytest.mark.parametrize("name", list(INTEGRALS))
def test_gto_integrals_match(mols, name):
    mol, jmol = mols
    assert mol.nao == jmol.nao and mol.nelectron == jmol.nelectron
    assert mol.energy_nuc() == jmol.energy_nuc()
    a = INTEGRALS[name](gto, mol)
    b = INTEGRALS[name](jgto, jmol)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_df_factor_matches(mols):
    mol, jmol = mols
    b = df.DF(mol).B_ao()
    jb = jdf.DF(jmol).B_ao()
    assert b.shape == jb.shape and b.shape[0] > mol.nao
    np.testing.assert_allclose(b, jb, rtol=0, atol=TOL)


def test_diis_extrapolation_matches():
    rng = np.random.default_rng(2)
    d, jd = diis.DIIS(space=4), jdiis.DIIS(space=4)
    x = rng.standard_normal(50)
    for _ in range(7):
        x = 0.6 * x + 0.1 * rng.standard_normal(50)
        err = rng.standard_normal(50) * 1e-2
        a = d.update(x, xerr=err)
        b = jd.update(x, xerr=err)
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def _same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_chkfile_copy_matches(tmp_path, writer):
    rng = np.random.default_rng(5)
    payload = {"e": np.float64(-0.25), "t2": rng.standard_normal((2, 2, 3, 3)),
               "nested": {"occ": np.arange(4), "seq": [np.ones(2), 3.5]}}
    path = str(tmp_path / f"{writer}.chk")
    save, load = ((chkfile.save, jchkfile.load) if writer == "port"
                  else (jchkfile.save, chkfile.load))
    save(path, "scf", payload)
    save(path, "scf", payload)          # overwriting a key
    out = load(path, "scf")
    _same(out, payload | {"nested": {"occ": np.arange(4),
                                     "seq": [np.ones(2), np.float64(3.5)]}})
    t1, t2 = rng.standard_normal((2, 3)), rng.standard_normal((2, 2, 3, 3))
    chkfile.dump_cc(path, -0.2, t1, t2, mo_coeff=np.eye(5))
    _same(jchkfile.load_cc(path), chkfile.load_cc(path))


def test_basis_library_is_identical():
    src = os.path.join(ROOT, "pyscf_mpcc_tpu", "gto", "basis_data")
    dst = os.path.join(ROOT, "pyscf_mpcc_tpu_torch", "gto", "basis_data")
    cmp = filecmp.dircmp(src, dst)
    assert not (cmp.left_only or cmp.right_only or cmp.diff_files)
    for sub in cmp.subdirs.values():
        assert not (sub.left_only or sub.right_only or sub.diff_files)


def test_native_engine_builds_outside_the_source_tree():
    # the port's copy builds its library into build/native at first use
    assert native._LIB.startswith(os.path.join(ROOT, "build", "native"))
    if native.available():
        assert os.path.isfile(native._LIB)


def test_config_and_stream_layers():
    for name in ("MAX_MEMORY", "VERBOSE", "CC_CONV_TOL", "CC_CONV_TOL_NORMT",
                 "SCF_CONV_TOL", "BASIS_PATH"):
        assert getattr(config, name) == getattr(jconfig, name)
    assert config.getattr_cfg("NOT_A_KEY", 7) == 7

    class Obj(stream.StreamObject):
        tol = 1e-3

        def __init__(self):
            self._declare_keys()

        def kernel(self):
            return self.tol

    obj = Obj().set(tol=1e-5)
    assert obj.tol == 1e-5 and obj.run() is obj
    log = logger.Logger(verbose=logger.INFO)
    assert log.timer("")


def test_pm_localization_matches(mols):
    mol, jmol = mols
    S = gto.intor_ovlp(mol)
    w, v = np.linalg.eigh(S)
    C = v[:, -5:] / np.sqrt(w[-5:])       # five S-orthonormal orbitals
    q = pm.lowdin_populations(mol, C, S=S)
    np.testing.assert_allclose(q, jpm.lowdin_populations(jmol, C, S=S),
                               rtol=0, atol=TOL)
    # S computed inside, from each package's own gto
    np.testing.assert_allclose(pm.lowdin_populations(mol, C), q, rtol=0,
                               atol=TOL)
    c_loc, u = pm.pm_localize(mol, C, S=S, max_sweeps=50)
    jc_loc, ju = jpm.pm_localize(jmol, C, S=S, max_sweeps=50)
    np.testing.assert_allclose(c_loc, jc_loc, rtol=0, atol=TOL)
    np.testing.assert_allclose(u, ju, rtol=0, atol=TOL)
    np.testing.assert_allclose(u.T @ u, np.eye(5), atol=1e-10)
    np.testing.assert_allclose(pm.PipekMezey(mol, C).kernel(), c_loc,
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("patterns", [["O p"], ["O s", "H s"]])
def test_avas_selection_matches(mols, patterns):
    """lo.avas on S-orthonormal orbitals (five occupied): the same active
    holes, particles and weights, S given or computed by each package's
    gto; a pattern matching no AO raises."""
    mol, jmol = mols
    S = gto.intor_ovlp(mol)
    w, v = np.linalg.eigh(S)
    C = v / np.sqrt(w)
    occ = np.zeros(mol.nao)
    occ[:5] = 2.0
    got = avas(mol, patterns, C, occ, threshold=0.2)
    want = javas(jmol, patterns, C, occ, threshold=0.2, S=S)
    for g, x in zip(got, want):
        np.testing.assert_allclose(g, x, rtol=0, atol=TOL)
    assert len(got[0]) + len(got[1]) >= 1
    assert lo.avas is avas
    with pytest.raises(ValueError, match="No AOs"):
        avas(mol, ["Xe f"], C, occ)


# (act_hole, act_particle, nocc, nvir, idx_s, idx_d)
MASK_SPACES = [([2, 4], [0, 3, 5], 5, 7, [0, 3], [1, 6, 15]),
               ([0], [1], 3, 4, list(range(4)), list(range(16))),
               ([2, 3, 4], [0, 1, 2, 3], 5, 19, [], list(range(15)))]


@pytest.mark.parametrize("space", MASK_SPACES)
def test_mpcc_masks_identical(space):
    ah, ap, no, nv, idx_s, idx_d = space
    pairs = [(masks.singles_blocks(ah, ap, no, nv),
              jmasks.singles_blocks(ah, ap, no, nv)),
             (masks.doubles_blocks(ah, ap, no, nv),
              jmasks.doubles_blocks(ah, ap, no, nv)),
             (masks.doubles_blocks(ah, ap, no, nv, [0], [1, 2], 2, 3),
              jmasks.doubles_blocks(ah, ap, no, nv, [0], [1, 2], 2, 3)),
             (masks.frozen_masks(ah, ap, no, nv, idx_s, idx_d),
              jmasks.frozen_masks(ah, ap, no, nv, idx_s, idx_d))]
    for got, want in pairs:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.bool_
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scheme", ["cdiis", "ediis", "adiis", "ediis+cdiis",
                                    "adiis+cdiis"])
def test_scf_energy_diis_matches(scheme):
    """scf.diis.make_scheme and the EDIIS/ADIIS extrapolations on a seeded
    history of spin-stacked densities and Focks."""
    obj, hybrid = scf_diis.make_scheme(scheme, space=4)
    jobj, jhybrid = jscf_diis.make_scheme(scheme, space=4)
    assert hybrid == jhybrid and type(obj).__name__ == type(jobj).__name__
    if obj is None:
        return
    rng = np.random.default_rng(5)
    for n in range(6):
        dm = rng.standard_normal((2, 6, 6))
        f = rng.standard_normal((2, 6, 6))
        e = -1.0 - 0.1 * n + 0.01 * rng.standard_normal()
        for o in (obj, jobj):
            o.push(e, dm + dm.transpose(0, 2, 1), f + f.transpose(0, 2, 1))
        np.testing.assert_allclose(obj.extrapolate(), jobj.extrapolate(),
                                   rtol=0, atol=TOL)


SPINORB_COPIES = ("cc/addons.py", "scf/ghf.py", "cc/gccsd_slow.py",
                  "ci/fci_slow.py", "cc/eom_slow.py", "cc/gccsdt1_slow.py",
                  "cc/gccsdt_slow.py", "mp/mp2f12.py", "lib/linalg.py")


@pytest.mark.parametrize("path", SPINORB_COPIES)
def test_spinorb_copy_is_the_original_source(path):
    src = open(os.path.join(ROOT, "pyscf_mpcc_tpu", path)).read()
    dst = open(os.path.join(ROOT, "pyscf_mpcc_tpu_torch", path)).read()
    note = (f"\nA host copy of the JAX package's {path} (NumPy, its imports "
            "pointed at\nthe port).\n")
    assert note in dst
    want = (src.replace("pyscf_mpcc_tpu.", "pyscf_mpcc_tpu_torch.")
            .replace("from pyscf_mpcc_tpu import",
                     "from pyscf_mpcc_tpu_torch import"))
    assert dst.replace(note, "") == want
    assert "jax" not in dst.replace("JAX package", "")


@pytest.fixture(scope="module")
def h4_so():
    from pyscf_mpcc_tpu import scf as jscf
    from pyscf_mpcc_tpu.cc import gccsd_slow as jgs
    from pyscf_mpcc_tpu_torch import scf
    from pyscf_mpcc_tpu_torch.cc import gccsd_slow
    atom = "H 0 0 0; H 0 0 0.9; H 0 0 1.8; H 0 0 2.7"
    out = []
    for g, s, gs in ((gto, scf, gccsd_slow), (jgto, jscf, jgs)):
        mf = s.RHF(g.M(atom=atom, basis="sto-3g"))
        mf.conv_tol = 1e-13
        mf.kernel()
        out.append(mf)
    out[0].mo_coeff = np.asarray(out[1].mo_coeff)
    return (gccsd_slow.eris_from_scf(out[0]), jgs.eris_from_scf(out[1]))


def test_spinorb_oracles_match(h4_so):
    from pyscf_mpcc_tpu.cc import addons as jaddons
    from pyscf_mpcc_tpu.cc import eom_slow as jeom
    from pyscf_mpcc_tpu.cc import gccsd_slow as jgs
    from pyscf_mpcc_tpu.cc import gccsdt1_slow as jt1
    from pyscf_mpcc_tpu.cc import gccsdt_slow as jt
    from pyscf_mpcc_tpu.ci import fci_slow as jfci
    from pyscf_mpcc_tpu_torch.cc import (addons, eom_slow, gccsd_slow,
                                         gccsdt1_slow, gccsdt_slow)
    from pyscf_mpcc_tpu_torch.ci import fci_slow
    so, jso = h4_so
    np.testing.assert_allclose(so.ints, jso.ints, rtol=0, atol=TOL)
    np.testing.assert_allclose(so.fock, jso.fock, rtol=0, atol=TOL)
    h, jh = eom_slow.h_so_from_eris(so), jeom.h_so_from_eris(jso)
    np.testing.assert_allclose(h, jh, rtol=0, atol=TOL)
    kw = dict(conv_tol=1e-11, conv_tol_normt=1e-9)
    e, t1, t2, _ = gccsd_slow.kernel(so, **kw)
    assert abs(e - jgs.kernel(jso, **kw)[0]) < TOL
    e_fci = fci_slow.FCI(h, so.ints, so.nocc, so.nso).kernel()[0]
    np.testing.assert_allclose(
        e_fci, jfci.FCI(jh, jso.ints, jso.nocc, jso.nso).kernel()[0],
        rtol=0, atol=TOL)
    act = dict(act_hole=[2, 3], act_particle=[0, 1], **kw)
    assert abs(gccsdt1_slow.kernel(so, **act)[0]
               - jt1.kernel(jso, **act)[0]) < TOL
    assert abs(gccsdt_slow.kernel(so, h, **act)[0]
               - jt.kernel(jso, jh, **act)[0]) < TOL
    rng = np.random.default_rng(1)
    r1, r2 = rng.standard_normal((2, 3)), rng.standard_normal((2, 2, 3, 3))
    r2 = r2 + r2.transpose(1, 0, 3, 2)
    for f, jf, x in ((addons.spatial2spin_t1, jaddons.spatial2spin_t1, r1),
                     (addons.spatial2spin_t2, jaddons.spatial2spin_t2, r2)):
        np.testing.assert_array_equal(f(x), jf(x))
