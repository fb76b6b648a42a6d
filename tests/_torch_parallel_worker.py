"""Ranks of the port's multi-process CPU tests (tests/test_torch_parallel.py
and tests/test_torch_ccsd_shard.py); not collected by pytest.

The test module builds the numpy inputs from seeds (``inputs``), writes
them to an .npz and starts one process per rank (``run_ranks``):

    RANK=r WORLD_SIZE=n python tests/_torch_parallel_worker.py \\
        SUITE INPUTS.npz OUT_DIR STORE_FILE

Each rank reads RANK and WORLD_SIZE from the environment as torchrun sets
them, joins a gloo group through parallel.distributed.initialize (a
file:// rendezvous at STORE_FILE), runs every case of SUITE on the CPU in
fp64 with one thread, and rank 0 writes each case's results, the ranks'
shards gathered, to OUT_DIR/<case>.npz.  A case that raises writes
OUT_DIR/<case>.err with its traceback and ends the process, so the other
ranks fail in their next collective instead of waiting in it; the parent
kills every rank that outlives its timeout.
"""

import os
import subprocess
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

# ------------------------------------------------------------- inputs
# the CPU tests' shapes: nocc a multiple of 4 (row shards at world sizes
# 2 and 4), naux not always one (the zero-padded aux path)
UPDATE_SHAPES = {"update_df": (8, 16, 32, "df_direct"),
                 "update_ovvv": (8, 16, 30, "df"),
                 "update_vvvv": (8, 10, 24, "vvvv")}
TILED_SHAPES = {"tiled": (8, 16, 24), "tiled_asym": (8, 14, 27),
                "kernel_tiled": (8, 16, 24), "submesh": (8, 12, 16)}
# (T): 35 tile triples at tile 2 (nvir 9 pads to 10), which neither world
# size divides
TRIPLES = dict(nocc=4, nvir=9, naux=13, tile=2)
UCCSD_T = dict(nocca=4, noccb=3, nvira=6, nvirb=7, naux=14, tile=2)
UCCSD_UPDATE = dict(nocca=8, noccb=4, nvira=6, nvirb=7, naux=22)
DIIS_N, DIIS_SPACE, DIIS_ITERS = 4 * 64, 4, 6


def rccsd_fields(nocc, nvir, naux, form="df_direct", seed=2024):
    """numpy RERIs fields of the DF-synthetic recipe: 'df' (Lvv + ovvv),
    'df_direct' (Lvv only), 'vvvv' (materialized ovvv and vvvv, no DF
    factors)."""
    rng = np.random.default_rng(seed)
    Loo = rng.random((naux, nocc, nocc)) * 0.05
    Loo = 0.5 * (Loo + Loo.transpose(0, 2, 1))
    Lov = rng.random((naux, nocc, nvir)) * 0.05
    Lvv = rng.random((naux, nvir, nvir)) * 0.05
    Lvv = 0.5 * (Lvv + Lvv.transpose(0, 2, 1))
    mo_e = np.sort(rng.random(nocc + nvir)) * 2.0
    mo_e[:nocc] -= 1.5
    fock = np.diag(mo_e)
    f = dict(fock=fock, mo_energy=mo_e.copy(),
             oooo=np.einsum("Lij,Lkl->ijkl", Loo, Loo),
             ovoo=np.einsum("Lia,Ljk->iajk", Lov, Loo),
             ovov=np.einsum("Lia,Ljb->iajb", Lov, Lov),
             oovv=np.einsum("Lij,Lab->ijab", Loo, Lvv),
             ovvo=None, ovvv=np.einsum("Lia,Lbc->iabc", Lov, Lvv),
             vvvv=None, Lvv=Lvv, Lov=Lov, Loo=Loo)
    if form == "df_direct":
        f["ovvv"] = None
    elif form == "vvvv":
        f["vvvv"] = np.einsum("Lab,Lcd->abcd", Lvv, Lvv)
        f.update(Lvv=None, Lov=None, Loo=None)
    return f


def amps(nocc, nvir, seed=7):
    """A nonzero t1 and a t2 with the (ij)(ab) swap symmetry."""
    rng = np.random.default_rng(seed)
    t1 = rng.standard_normal((nocc, nvir)) * 0.05
    t2 = rng.standard_normal((nocc, nocc, nvir, nvir)) * 0.05
    return t1, 0.5 * (t2 + t2.transpose(1, 0, 3, 2))


def ueris_fields(nocca, noccb, nvira, nvirb, naux, materialize=False):
    """numpy UERIs fields of testing.synthetic_ueris (fp64, seed 0)."""
    import torch
    from pyscf_mpcc_tpu_torch import testing
    ue = testing.synthetic_ueris(nocca, noccb, nvira, nvirb, naux,
                                 device=torch.device("cpu"),
                                 dtype=torch.float64,
                                 materialize=materialize)
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in ue._asdict().items() if k != "mesh"}


def uamps(nocca, noccb, nvira, nvirb, seed=11):
    """Random (t1a, t1b), (t2aa, t2ab, t2bb) with the spin-orbital
    antisymmetry of the same-spin blocks."""
    rng = np.random.default_rng(seed)

    def r(*s):
        return rng.standard_normal(s) * 0.05

    def anti(x):
        x = x - x.transpose(1, 0, 2, 3)
        return x - x.transpose(0, 1, 3, 2)

    return ((r(nocca, nvira), r(noccb, nvirb)),
            (anti(r(nocca, nocca, nvira, nvira)),
             r(nocca, noccb, nvira, nvirb),
             anti(r(noccb, noccb, nvirb, nvirb))))


def inputs(suite):
    """The numpy inputs of a suite: {case: {name: array | None | int}}."""
    from pyscf_mpcc_tpu_torch import testing
    out = {}
    if suite not in ("parallel", "ccsd_shard", "gpu_shared"):
        raise ValueError(suite)
    if suite in ("parallel", "gpu_shared"):
        for case, (no, nv, na, form) in UPDATE_SHAPES.items():
            t1, t2 = amps(no, nv)
            out[case] = dict(fields=rccsd_fields(no, nv, na, form), t1=t1,
                             t2=t2)
        rng = np.random.default_rng(0)
        out["ladder"] = dict(ld=rng.standard_normal((64, 16, 16)) * 0.1,
                             tau=rng.standard_normal((6, 6, 16, 16)) * 0.1)
        t1, t2, f = testing.random_triples_problem(
            TRIPLES["nocc"], TRIPLES["nvir"], 5, naux=TRIPLES["naux"])
        out["ccsd_t"] = dict(fields=f, t1=t1, t2=t2)
        u = UCCSD_T
        t1, t2 = uamps(u["nocca"], u["noccb"], u["nvira"], u["nvirb"])
        out["uccsd_t"] = dict(
            fields=ueris_fields(*(u[k] for k in ("nocca", "noccb", "nvira",
                                                 "nvirb", "naux"))),
            t1=t1, t2=t2)
        u = UCCSD_UPDATE
        shape = [u[k] for k in ("nocca", "noccb", "nvira", "nvirb")]
        t1, t2 = uamps(*shape)
        for case, mat in (("uccsd_update", False),
                          ("uccsd_update_mat", True)):
            out[case] = dict(fields=ueris_fields(*shape, u["naux"], mat),
                             t1=t1, t2=t2)
        rng = np.random.default_rng(0)
        out["diis"] = dict(
            x=rng.standard_normal((DIIS_ITERS, DIIS_N)),
            e=rng.standard_normal((DIIS_ITERS, DIIS_N))
            * 0.1 ** np.arange(DIIS_ITERS)[:, None])
    if suite in ("ccsd_shard", "gpu_shared"):
        out["t_exchange"] = dict(
            x=np.random.RandomState(3).randn(8, 8, 6, 6))
        for case, (no, nv, na) in TILED_SHAPES.items():
            t1, t2 = amps(no, nv)
            out[case] = dict(fields=rccsd_fields(no, nv, na), t1=t1, t2=t2)
    return out


def _flatten(d, prefix=""):
    flat = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key + "/"))
        elif isinstance(v, (tuple, list)):
            flat.update(_flatten(dict(enumerate(v)), key + "/"))
        elif v is not None:
            flat[key] = np.asarray(v)
    return flat


def _unflatten(npz, case):
    """{name: array} of one case; fields and amplitude tuples nested."""
    out = {}
    for key in npz.files:
        head, *rest = key.split("/")
        if head != case:
            continue
        d = out
        for part in rest[:-1]:
            d = d.setdefault(part, {})
        d[rest[-1]] = npz[key]
    return out


def _tuple(d):
    return tuple(d[str(i)] for i in range(len(d)))


# ------------------------------------------------------------- launcher
def run_ranks(suite, world, tmp_path, timeout=300, env=None):
    """Run SUITE on WORLD ranks; returns (out_dir, {rank: log}).  env: the
    ranks' environment (default tests/conftest.clean_child_env's)."""
    if env is None:
        from conftest import clean_child_env
        env = clean_child_env()
    inp = os.path.join(tmp_path, "inputs.npz")
    np.savez(inp, **_flatten(inputs(suite)))
    out = os.path.join(tmp_path, "out")
    os.makedirs(out, exist_ok=True)
    store = os.path.join(tmp_path, "store")
    logs = [open(os.path.join(tmp_path, f"rank{r}.log"), "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, inp, out, store],
        env=dict(env, RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(r), OMP_NUM_THREADS="1"),
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = {}
    for r, f in enumerate(logs):
        f.seek(0)
        text[r] = f"rc={procs[r].returncode}\n" + f.read()[-4000:]
        f.close()
    return out, text


def result(out, logs, case):
    """The npz results of one case, or an AssertionError with the case's
    traceback or the ranks' logs."""
    path = os.path.join(out, case)
    if os.path.exists(path + ".npz"):
        return dict(np.load(path + ".npz"))
    if os.path.exists(path + ".err"):
        raise AssertionError(open(path + ".err").read())
    raise AssertionError(f"case {case} did not run:\n" + "\n".join(
        f"--- rank {r}: {t}" for r, t in logs.items()))


# ------------------------------------------------------------- the cases
def _cases_parallel(torch, mesh):
    import torch.distributed as dist
    from pyscf_mpcc_tpu_torch import convert, testing
    from pyscf_mpcc_tpu_torch.cc import ccsd_t, uccsd_t
    from pyscf_mpcc_tpu_torch.lib import device_diis
    from pyscf_mpcc_tpu_torch.parallel import mesh as pm
    from pyscf_mpcc_tpu_torch.parallel.ladder_shard import ladder_sharded

    dev, f64 = mesh.device, torch.float64

    def t(x):
        return torch.tensor(x, dtype=f64, device=dev)

    def every(x):
        """The ranks' x stacked along a new first axis."""
        return mesh.all_gather(torch.as_tensor(x, device=dev)[None])

    def collectives(d):
        r = mesh.rank
        x = torch.arange(4.0 * mesh.size, dtype=f64, device=dev).reshape(
            mesh.size, 4) + 100 * r
        return dict(
            world=np.array([dist.get_world_size(), mesh.size,
                            int(mesh.backend == "gloo")]),
            rank=every(torch.tensor(r)),
            psum=mesh.psum(x.clone()),
            psum_many=torch.cat(mesh.psum_many(x[:1], x[1:])),
            gather0=every(mesh.all_gather(x)),
            gather1=every(mesh.all_gather(x, dim=1)),
            a2a=every(mesh.all_to_all(x)),
            ring=every(mesh.ring_shift(x)),
            bcast=every(mesh.broadcast(x.clone(), 0)))

    def update(d, ntile=2):
        er = convert.eris_from_numpy(d["fields"], dev, f64)
        es = pm.shard_eris(er, mesh)
        t1s, t2s = pm.shard_amps(t(d["t1"]), t(d["t2"]), mesh)
        o1, o2 = pm.sharded_update_amps(mesh, ntile=ntile)(t1s, t2s, es)
        lvv = -1 if es.Lvv is None else es.Lvv.shape[0]
        ovvv = -1 if es.ovvv is None else es.ovvv.shape[0]
        return dict(t1=o1, t2=mesh.all_gather(o2),
                    shards=every(torch.tensor([lvv, ovvv, t2s.shape[0]])))

    def ladder(d):
        ld = mesh.rows(t(d["ld"]))
        return dict(out=ladder_sharded(t(d["tau"]), ld, mesh, ntile=2))

    def triples(d):
        fields = {k: d["fields"].get(k) for k in (
            "fock", "mo_energy", "ovoo", "ovov", "ovvv", "Lov", "Lvv")}
        t1, t2, er = testing.triples_tensors(d["t1"], d["t2"], fields, dev,
                                             f64)
        out = {eng: ccsd_t.kernel(t1, t2, er, tile=TRIPLES["tile"],
                                  engine=eng, mesh=mesh)
               for eng in ("xla", "fused", "resident")}
        nvt = -(-TRIPLES["nvir"] // TRIPLES["tile"])
        out["tiles"] = every(torch.tensor(
            len(ccsd_t.mesh_block(ccsd_t._tile_triples(nvt), mesh))))
        return out

    def uccsd_triples(d):
        ue = convert.ueris_from_numpy(d["fields"], dev, f64)
        e = uccsd_t.kernel(tuple(map(t, _tuple(d["t1"]))),
                           tuple(map(t, _tuple(d["t2"]))), ue,
                           tile=UCCSD_T["tile"], mesh=mesh)
        return dict(e=e)

    def uupdate(d):
        ue = convert.ueris_from_numpy(d["fields"], dev, f64)
        us = pm.shard_ueris(ue, mesh)
        t1s, t2s = pm.shard_uamps(tuple(map(t, _tuple(d["t1"]))),
                                  tuple(map(t, _tuple(d["t2"]))), mesh)
        o1, o2 = pm.sharded_uccsd_update(mesh, ntile=2)(t1s, t2s, us)
        res = {f"t1_{i}": x for i, x in enumerate(o1)}
        res.update({f"t2_{i}": mesh.all_gather(x) for i, x in enumerate(o2)})
        return res

    def diis(d):
        n = d["x"].shape[1]
        sh = device_diis.init(n // mesh.size, DIIS_SPACE, f64, device=dev)
        rep = device_diis.init(n, DIIS_SPACE, f64, device=dev)
        outs, outr = [], []
        for x, e in zip(t(d["x"]), t(d["e"])):
            sh, o = device_diis.update_hostsolve(sh, mesh.rows(x),
                                                 mesh.rows(e), mesh)
            outs.append(mesh.all_gather(o))
            rep, o = device_diis.update_hostsolve(rep, x, e)
            outr.append(o)
        return dict(sharded=torch.stack(outs), replicated=torch.stack(outr),
                    history=np.array(sh.xs.shape))

    return dict(collectives=collectives, update_df=update,
                update_ovvv=update, update_vvvv=update, ladder=ladder,
                ccsd_t=triples, uccsd_t=uccsd_triples,
                uccsd_update=uupdate, uccsd_update_mat=uupdate, diis=diis)


def _cases_ccsd_shard(torch, mesh):
    from pyscf_mpcc_tpu_torch import convert
    from pyscf_mpcc_tpu_torch.parallel import ccsd_shard as cs
    from pyscf_mpcc_tpu_torch.parallel.mesh import make_mesh

    dev, f64 = mesh.device, torch.float64

    def t(x):
        return torch.tensor(x, dtype=f64, device=dev)

    def exchange(d):
        y = cs._t_exchange(mesh.rows(t(d["x"])), mesh)
        return dict(y=mesh.all_gather(y))

    def tiled(d, m, ntile, nchunk):
        er = convert.eris_from_numpy(d["fields"], dev, f64)
        es = cs.shard_eris_tiled(er, m)
        t1s, t2s = cs.shard_amps_tiled(t(d["t1"]), t(d["t2"]), m)
        o1, o2 = cs.update_amps_tiled(t1s, t2s, es, m, ntile=ntile,
                                      nchunk=nchunk)
        errs = []
        # nocc % N and an unpadded aux axis (on a mesh of more than one)
        for bad in ((t1s[:7], es), (t1s, es._replace(Lov=es.Lov[:-1]))):
            try:
                if m.size > 1:
                    cs.update_amps_tiled(bad[0], t2s, bad[1], m)
            except ValueError as exc:
                errs.append(str(exc))
        return dict(t1=o1, t2=m.all_gather(o2),
                    lvv_rows=np.array(es.Lvv.shape[0]),
                    errors=np.array(errs))

    def kernel(d):
        es = cs.shard_eris_tiled(
            convert.eris_from_numpy(d["fields"], dev, f64), mesh)
        conv, e, t1, t2 = cs.kernel_tiled(es, mesh, conv_tol=1e-10,
                                          conv_tol_normt=1e-8, ntile=2,
                                          nchunk=2)
        return dict(conv=np.array(conv), e=np.array(e))

    def submesh(d):
        sub = make_mesh(mesh.size // 2, device=dev)
        if sub is None:
            return dict(member=np.array(False))
        out = tiled(d, sub, 2, 1)
        out["member"] = np.array(True)
        out["size"] = np.array(sub.size)
        return out

    cases = dict(t_exchange=exchange,
                 tiled=lambda d: tiled(d, mesh, 4, 2),
                 tiled_asym=lambda d: tiled(d, mesh, 3, 3),
                 kernel_tiled=kernel, submesh=submesh)
    return cases


def suite_cases(torch, suite, mesh):
    """{case: fn(inputs) -> results} of a suite on this rank's mesh.
    'gpu_shared' (the card's test, tests/test_torch_parallel_gpu.py): the
    mesh (T) and the sharded and tiled updates, on a card the ranks
    share."""
    if suite == "parallel":
        return _cases_parallel(torch, mesh)
    if suite == "ccsd_shard":
        return _cases_ccsd_shard(torch, mesh)
    par = _cases_parallel(torch, mesh)
    return dict(ccsd_t=par["ccsd_t"], update_df=par["update_df"],
                update_ovvv=par["update_ovvv"],
                tiled=_cases_ccsd_shard(torch, mesh)["tiled"])


def main(suite, inp_path, out, store):
    import torch
    torch.set_num_threads(1)
    from pyscf_mpcc_tpu_torch.parallel import distributed
    from pyscf_mpcc_tpu_torch.parallel.mesh import make_mesh
    # gpu_shared: every rank on the one card, over gloo
    dev = (torch.device("cuda", 0) if suite == "gpu_shared"
           else torch.device("cpu"))
    assert distributed.initialize(init_method=f"file://{store}", device=dev,
                                  backend="gloo")
    mesh = make_mesh(device=dev)
    npz = np.load(inp_path)
    for case, fn in suite_cases(torch, suite, mesh).items():
        try:
            res = fn(_unflatten(npz, case))
        except Exception:
            with open(os.path.join(out, f"{case}.err"), "w") as f:
                f.write(f"rank {mesh.rank}:\n{traceback.format_exc()}")
            sys.stdout.flush()
            os._exit(1)
        if mesh.rank == 0:
            np.savez(os.path.join(out, case), **{
                k: (v.cpu().numpy() if torch.is_tensor(v)
                    else np.asarray(v)) for k, v in res.items()})
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:5])
