"""Spin-traced einsum over spin-blocked tensors.

Port of ``pyscf_mpcc_tpu/cc/spinsum.py``.  The unrestricted CC equations
are the spin-orbital equations evaluated over (alpha, beta) blocks: each
spin-orbital tensor is a dict of spin blocks (``ST``), and ``seinsum``
enumerates the spin assignments consistent across shared subscript letters
and runs one dense ``torch.einsum`` per surviving case.

PyTorch runs eagerly, so the enumeration (pure Python) runs on every call
rather than once at trace time as in JAX; ``chip_smoke.py`` phase 9 times
its share of a sweep.  ``ST.transpose`` takes a full axis permutation, as
the JAX version's NumPy-style ``transpose(axes)`` does, and maps it to
``Tensor.permute`` (``Tensor.transpose`` swaps two axes); a permuted block
is a view.

Antisymmetrized-integral blocks carry all six conserving spin signatures
(aaaa/bbbb/abab/abba/baab/baba); amplitude blocks carry the conventional
three (t2: 'aaaa', 'abab', 'bbbb', the other mixed signatures implied by
antisymmetry).
"""

from __future__ import annotations

from itertools import product

import torch


class ST:
    """A spin-blocked tensor: dict of spin-signature -> tensor.

    The signature string has one character ('a' or 'b') per index, in the
    tensor's index order.  Missing signatures are implicitly zero.
    """

    __slots__ = ("b",)

    def __init__(self, blocks=None):
        self.b = {k: v for k, v in (blocks or {}).items() if v is not None}

    def __getitem__(self, key):
        return self.b[key]

    def get(self, key, default=None):
        return self.b.get(key, default)

    def keys(self):
        return self.b.keys()

    # -- arithmetic (blockwise; missing blocks are zero) -------------------
    def _binop(self, other, f):
        out = {}
        for k in set(self.b) | set(other.b):
            x, y = self.b.get(k), other.b.get(k)
            if x is None:
                out[k] = f(0.0, y)
            elif y is None:
                out[k] = f(x, 0.0)
            else:
                out[k] = f(x, y)
        return ST(out)

    def __add__(self, other):
        return self._binop(other, lambda x, y: x + y)

    def __sub__(self, other):
        return self._binop(other, lambda x, y: x - y)

    def __mul__(self, s):
        return ST({k: s * v for k, v in self.b.items()})

    __rmul__ = __mul__

    def __neg__(self):
        return self * (-1.0)

    def transpose(self, axes):
        """Permute tensor axes (and the signature accordingly)."""
        return ST({"".join(k[a] for a in axes): v.permute(*axes)
                   for k, v in self.b.items()})


def seinsum(sub, *ops):
    """Spin-traced einsum: ``seinsum('mnef,jnfb->mbej', g_oovv, t2)``.

    Every operand is an ST.  Shared letters must carry the same spin; each
    consistent assignment contributes one dense einsum, accumulated into
    the output block keyed by the output letters' spins.
    """
    ins, out = sub.split("->")
    terms = ins.split(",")
    assert len(terms) == len(ops)
    out_blocks = {}
    for combo in product(*[list(op.b.keys()) for op in ops]):
        assign = {}
        ok = True
        for term, key in zip(terms, combo):
            for ltr, s in zip(term, key):
                if assign.setdefault(ltr, s) != s:
                    ok = False
                    break
            if not ok:
                break
        if not ok:
            continue
        okey = "".join(assign[ltr] for ltr in out)
        val = torch.einsum(sub, *[op.b[key] for op, key in zip(ops, combo)])
        prev = out_blocks.get(okey)
        out_blocks[okey] = val if prev is None else prev + val
    return ST(out_blocks)


def asym(x: ST, ax1: int, ax2: int) -> ST:
    """Antisymmetrize: X - X with axes (and spins) ax1<->ax2 swapped."""
    out = {}
    for k, v in x.b.items():
        ks = list(k)
        ks[ax1], ks[ax2] = ks[ax2], ks[ax1]
        ks = "".join(ks)
        out[k] = out.get(k, 0.0) + v
        out[ks] = out.get(ks, 0.0) - v.transpose(ax1, ax2)
    return ST(out)


def anti4(direct_aa, direct_bb, direct_ab, swap_last=None,
          direct_ba=None):
    """The six conserving blocks of an antisymmetrized 4-index tensor
    <pq||rs> from its direct (not antisymmetrized) blocks.

    direct_aa/bb: <pq|rs> same-spin blocks (antisymmetrized through
        swap_last, which returns <pq|sr> for a same-spin block; default:
        swap the last two axes).
    direct_ab: <pQ|rS> (signature 'abab'); direct_ba defaults to the
        particle-exchange image of direct_ab (permute (1,0,3,2)).
    The 'abba'/'baab' blocks follow from antisymmetry: <pQ||Rs> = -<pQ|sR>.
    """
    if swap_last is None:
        def swap_last(x):
            return x.permute(0, 1, 3, 2)
    if direct_ba is None:
        direct_ba = direct_ab.permute(1, 0, 3, 2)
    return ST({
        "aaaa": direct_aa - swap_last(direct_aa),
        "bbbb": direct_bb - swap_last(direct_bb),
        "abab": direct_ab,
        "baba": direct_ba,
        "abba": -swap_last(direct_ab),
        "baab": -swap_last(direct_ba),
    })


def t1_st(t1):
    """(t1a, t1b) -> ST with signatures 'aa'/'bb'."""
    return ST({"aa": t1[0], "bb": t1[1]})


def t2_st(t2):
    """(t2aa, t2ab, t2bb) -> ST carrying all conserving signatures.

    t2ab[i,J,a,B] is the canonical mixed block; the other mixed
    signatures follow from the antisymmetry of the spin-orbital
    amplitude: t2[iJaB] = -t2[JiaB] = -t2[iJBa] = t2[JiBa].
    """
    t2aa, t2ab, t2bb = t2
    return ST({
        "aaaa": t2aa,
        "bbbb": t2bb,
        "abab": t2ab,
        "baba": t2ab.permute(1, 0, 3, 2),
        "abba": -t2ab.permute(0, 1, 3, 2),
        "baab": -t2ab.permute(1, 0, 2, 3),
    })


def st_t1(x: ST):
    return x["aa"], x["bb"]


def st_t2(x: ST):
    return x["aaaa"], x["abab"], x["bbbb"]
