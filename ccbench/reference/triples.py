"""Plain fp64 (T) correction of closed-shell CCSD.

The energy of PySCF's ccsd_t_slow, written over whole slices: for each
virtual a and a block of b <= a, the connected triples W_abc[i,j,k] and the
disconnected V_abc[i,j,k] are formed for every c <= b at once, and

    E(T) = 2 / 6 * sum_{a >= b >= c} m_abc sum_{ijk} W_abc r3(W_abc + V_abc) / D_abc

with r3(w) = 4 w + w_jki + w_kij - 2 w_kji - 2 w_ikj - 2 w_jik and m_abc the
number of distinct permutations of (a, b, c).  Both W and V are sums over
the six joint permutations of (a, b, c) and (i, j, k) of one base term, so
the summand is invariant under such a permutation and the restricted sum
with these multiplicities is the sum over all triples (PySCF's degeneracy
weights).  The operations this needs are counted in harness/counts.py.

Every (ov|vv) element is formed from the DF factors of reference/ccsd.Ints.
"""

from __future__ import annotations

import torch

einsum = torch.einsum


def _r3(w):
    # w[b, c, i, j, k]
    return (4.0 * w + w.permute(0, 1, 3, 4, 2) + w.permute(0, 1, 4, 2, 3)
            - 2.0 * w.permute(0, 1, 4, 3, 2) - 2.0 * w.permute(0, 1, 2, 4, 3)
            - 2.0 * w.permute(0, 1, 3, 2, 4))


def _multiplicity(a, bs, nc, dtype, device):
    """[b, c] weights of the restricted sum a >= b >= c: the number of
    distinct permutations of (a, b, c), 0 where c > b."""
    b = torch.arange(bs.start, bs.stop, device=device)[:, None]
    c = torch.arange(nc, device=device)[None, :]
    m = torch.full((b.shape[0], nc), 6.0, dtype=dtype, device=device)
    m = torch.where((b == a) | (b == c), torch.full_like(m, 3.0), m)
    m = torch.where((b == a) & (b == c), torch.ones_like(m), m)
    return torch.where(c > b, torch.zeros_like(m), m)


def energy(t1, t2, ints, rows=32):
    """E(T) of amplitudes (t1, t2) on ints (reference/ccsd.Ints), in fp64.
    ``rows``: how many b of each a-slice are formed at once."""
    f64 = torch.float64
    t1 = t1.to(f64)
    t2 = t2.to(f64)
    nocc, nvir = t1.shape
    dev = t1.device
    eo, ev = ints.eo, ints.ev
    fvo = ints.fov.T
    # g[i, x, f, y] = (ix|fy); h[i, x, m, j] = (ix|mj); p[i,x,j,y] = (ix|jy)
    g = einsum("Lix,Lfy->ixfy", ints.Lov, ints.Lvv)
    h = ints.ovoo
    p = ints.ovov
    eijk = eo[:, None, None] + eo[None, :, None] + eo[None, None, :]
    total = torch.zeros((), dtype=f64, device=dev)
    for a in range(nvir):
        # the base term w(x, y, z)[i, j, k] = sum_f (ix|fy) t2[k,j,z,f]
        # - sum_m (ix|mj) t2[m,k,y,z] with a in each of its three slots,
        # over the virtuals <= a that a >= b >= c needs:
        # s1[y, z] = w(a, y, z); s2[x, z] = w(x, a, z); s3[x, y] = w(x, y, a)
        n = a + 1
        s1 = (einsum("ify,kjzf->yzijk", g[:, a, :, :n], t2[:, :, :n])
              - einsum("imj,mkyz->yzijk", h[:, a], t2[:, :, :n, :n]))
        s2 = (einsum("ixf,kjzf->xzijk", g[:, :n, :, a], t2[:, :, :n])
              - einsum("ixmj,mkz->xzijk", h[:, :n], t2[:, :, a, :n]))
        s3 = (einsum("ixfy,kjf->xyijk", g[:, :n, :, :n], t2[:, :, a])
              - einsum("ixmj,mky->xyijk", h[:, :n], t2[:, :, :n, a]))
        for b0 in range(0, n, rows):
            b1 = min(b0 + rows, n)
            bs = slice(b0, b1)
            cs = slice(0, b1)
            # W_abc[i,j,k] = w(a,b,c)[i,j,k] + w(a,c,b)[i,k,j]
            #   + w(b,a,c)[j,i,k] + w(b,c,a)[j,k,i] + w(c,a,b)[k,i,j]
            #   + w(c,b,a)[k,j,i], for b in bs and c < b1, laid out
            #   [b, c, i, j, k]
            w = s1[bs, cs].clone()
            w += s1[cs, bs].permute(1, 0, 2, 4, 3)
            w += s2[bs, cs].permute(0, 1, 3, 2, 4)
            w += s3[bs, cs].permute(0, 1, 4, 2, 3)
            w += s2[cs, bs].permute(1, 0, 3, 4, 2)
            w += s3[cs, bs].permute(1, 0, 4, 3, 2)
            x = w + _v_abc(a, bs, cs, t1, t2, p, fvo)
            x = _r3(x)
            x /= (eijk[None, None] - ev[a] - ev[bs, None, None, None, None]
                  - ev[None, cs, None, None, None])
            x *= w
            total += torch.sum(_multiplicity(a, bs, b1, f64, dev)
                               * torch.sum(x, dim=(2, 3, 4)))
            del w, x
        del s1, s2, s3
    return float(2.0 / 6.0 * total)


def _v_abc(a, bs, cs, t1, t2, p, fvo):
    """V_abc[i,j,k] for fixed a, b in bs and c in cs: the six joint
    placements of v(x,y,z)[i,j,k] = ((ix|jy) t1[k,z] + t2[i,j,x,y] fvo[z,k]) / 2
    as in W_abc."""
    # gathered blocks, all shaped [b, c, i, j, k]
    # v(a,b,c)[i,j,k] = ((ia|jb) t1[k,c] + t2[i,j,a,b] fvo[c,k]) / 2
    pab = p[:, a, :, bs].permute(2, 0, 1)            # [b, i, j] = (ia|jb)
    tab = t2[:, :, a, bs].permute(2, 0, 1)           # [b, i, j] = t2[i,j,a,b]
    t1T = t1.T                                       # [c, k]
    v1 = (einsum("bij,ck->bcijk", pab, t1T[cs])
          + einsum("bij,ck->bcijk", tab, fvo[cs]))
    # v(a,c,b)[i,k,j]: ((ia|kc) t1[j,b] + t2[i,k,a,c] fvo[b,j]) / 2
    pac = p[:, a, :, cs].permute(2, 0, 1)            # [c, i, k]
    tac = t2[:, :, a, cs].permute(2, 0, 1)           # [c, i, k]
    v2 = (einsum("cik,bj->bcijk", pac, t1T[bs])
          + einsum("cik,bj->bcijk", tac, fvo[bs]))
    # v(b,a,c)[j,i,k]: ((jb|ia) t1[k,c] + t2[j,i,b,a] fvo[c,k]) / 2
    pba = p[:, bs, :, a].permute(1, 2, 0)            # [b, i, j] = (jb|ia)
    tba = t2[:, :, bs, a].permute(2, 1, 0)           # [b, i, j] = t2[j,i,b,a]
    v3 = (einsum("bij,ck->bcijk", pba, t1T[cs])
          + einsum("bij,ck->bcijk", tba, fvo[cs]))
    # v(b,c,a)[j,k,i]: ((jb|kc) t1[i,a] + t2[j,k,b,c] fvo[a,i]) / 2
    pbc = p[:, bs, :, cs].permute(1, 3, 0, 2)        # [b, c, j, k] = (jb|kc)
    tbc = t2[:, :, bs, cs].permute(2, 3, 0, 1)       # [b, c, j, k]
    v4 = (einsum("bcjk,i->bcijk", pbc, t1T[a])
          + einsum("bcjk,i->bcijk", tbc, fvo[a]))
    # v(c,a,b)[k,i,j]: ((kc|ia) t1[j,b] + t2[k,i,c,a] fvo[b,j]) / 2
    pca = p[:, cs, :, a].permute(1, 2, 0)            # [c, i, k] = (kc|ia)
    tca = t2[:, :, cs, a].permute(2, 1, 0)           # [c, i, k] = t2[k,i,c,a]
    v5 = (einsum("cik,bj->bcijk", pca, t1T[bs])
          + einsum("cik,bj->bcijk", tca, fvo[bs]))
    # v(c,b,a)[k,j,i]: ((kc|jb) t1[i,a] + t2[k,j,c,b] fvo[a,i]) / 2
    pcb = p[:, cs, :, bs].permute(3, 1, 2, 0)        # [b, c, j, k] = (kc|jb)
    tcb = t2[:, :, cs, bs].permute(3, 2, 1, 0)       # [b, c, j, k] = t2[k,j,c,b]
    v6 = (einsum("bcjk,i->bcijk", pcb, t1T[a])
          + einsum("bcjk,i->bcijk", tcb, fvo[a]))
    return 0.5 * (v1 + v2 + v3 + v4 + v5 + v6)
