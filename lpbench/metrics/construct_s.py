"""construct_s: the mean seconds of a request's constructor
(BatchedPhase1Solver.__init__: the operands, A.^2 and the kernel plans), by
the host's clock, ended by a synchronize."""
from ._common import mean


def read(record: dict):
    return mean(record, "construct_s")
