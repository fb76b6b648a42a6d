"""Design probes of the (T) engines on the card: ports of the JAX
package's ``tools/triples_probe_v6.py`` and ``tools/slab_loop_probe.py``,
each Pallas kernel a hand-written CUDA kernel (``ops/csrc``) with a plain
PyTorch version beside it; and ``profile_phases``, a cProfile of the chip
script's host-bound phases."""
