"""lp_ipm1_s: the mean over finished requests of the seconds in the span
ipxt.lp.ipm1 of LpSolver.solve(): the starting point and the initial IPM,
kkt/diag.py's CR (K3 on the card) inside."""
from ._lp import mean_of


def read(record: dict):
    return mean_of(record, "ipxt.lp.ipm1")
