"""StreamObject: the chainable method-object base class.

Covers the reference's ``pyscf/lib/misc.py:578`` StreamObject surface —
``.set()`` / ``.run()`` / ``.apply()`` / ``check_sanity()`` /
``dump_flags()`` — so driver objects compose the same way
(``CCSD(mf).set(conv_tol=1e-9).run()``).  Unlike the reference there is no
I/O plumbing here: flags dump through lib.logger and sanity checking is a
pure attribute-name audit against the class's declared keys.
"""

from __future__ import annotations

import warnings

from pyscf_mpcc_tpu_torch.lib import logger
from pyscf_mpcc_tpu_torch import config


class StreamObject:
    verbose = config.VERBOSE
    # class-level attribute names considered "known"; subclasses extend via
    # plain class attributes (collected automatically in _known_keys)
    _keys = frozenset()

    def kernel(self, *args, **kwargs):
        raise NotImplementedError

    # ---------------------------------------------------------- streaming
    def set(self, *args, **kwargs):
        if args:
            warnings.warn("StreamObject.set supports keyword arguments only;"
                          f" positional {args} ignored")
        for k, v in kwargs.items():
            setattr(self, k, v)
        return self

    def run(self, *args, **kwargs):
        self.set(**kwargs)
        self.kernel(*args)
        return self

    def apply(self, fn, *args, **kwargs):
        return fn(self, *args, **kwargs)

    # ------------------------------------------------------------- checks
    def _declare_keys(self):
        """Snapshot the attributes set so far as the known-key set; call
        at the end of __init__ so check_sanity flags only attributes
        invented afterwards (the reference's _keys discipline,
        misc.py:602)."""
        object.__setattr__(
            self, "_keys",
            frozenset(self._known_keys()) | set(vars(self)))
        return self

    def _known_keys(self):
        keys = set(getattr(self, "_keys", ()))
        for cls in type(self).__mro__:
            keys.update(k for k in vars(cls) if not k.startswith("_"))
            keys.update(getattr(cls, "_keys", ()))
        return keys

    def check_sanity(self):
        """Warn about instance attributes that shadow no declared key —
        the typo guard of the reference check_sanity (misc.py:662)."""
        known = self._known_keys()
        unknown = [k for k in vars(self)
                   if not k.startswith("_") and k not in known]
        if unknown:
            warnings.warn(
                f"{type(self).__name__} has unrecognized attributes "
                f"{sorted(unknown)}; known keys: {sorted(known)}")
        return self

    def dump_flags(self, verbose=None):
        log = logger.Logger(
            verbose=verbose if verbose is not None else self.verbose)
        log.info("\n******** %s ********", type(self).__name__)
        for k in sorted(self._known_keys()):
            v = getattr(self, k, None)
            if callable(v) or k in ("mol", "stdout"):
                continue
            if hasattr(v, "shape"):
                v = f"<array {getattr(v, 'shape', ())}>"
            log.info("%s = %s", k, v)
        return self

    def view(self, cls):
        """Reinterpret as another driver class sharing the same state."""
        new = object.__new__(cls)
        new.__dict__.update(self.__dict__)
        return new
