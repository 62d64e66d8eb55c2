"""What the readers of the entry lp_solve share: the mean over finished
requests of a number that a request's info carries only where the program
has it (solver.trace), else None."""
from ._common import finished


def mean_of(record: dict, key: str):
    values = [r[key] for r in finished(record) if key in r]
    return float(sum(values) / len(values)) if values else None
