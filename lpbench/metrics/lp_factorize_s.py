"""lp_factorize_s: the mean over finished requests of the seconds in the span
ipxt.lp.factorize: phase 2's factorize steps (DropPrimal, DropDual,
maxvolume, the native LU), kkt/basis_precond.py."""
from ._lp import mean_of


def read(record: dict):
    return mean_of(record, "ipxt.lp.factorize")
