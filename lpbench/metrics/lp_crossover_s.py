"""lp_crossover_s: the mean over finished requests of the seconds in the span
ipxt.lp.crossover: the dual and primal push phases of basis/crossover.py."""
from ._lp import mean_of


def read(record: dict):
    return mean_of(record, "ipxt.lp.crossover")
