"""Basis / simplex linear algebra layer: sparse LU (native kernel),
basis manager, starting-basis construction, maxvolume, crossover.

The port's copy of ipx_tpu/basis/__init__.py.
"""
