"""lp_kkt2_s: the mean over finished requests of the seconds in the span
ipxt.lp.kkt2: phase 2's CR solves (ops/device_cr2.py, K4's N N' applies on
the card, the B and B' solves on the host)."""
from ._lp import mean_of


def read(record: dict):
    return mean_of(record, "ipxt.lp.kkt2")
