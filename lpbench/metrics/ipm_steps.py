"""ipm_steps: the mean over requests of the stage's IPM steps (the largest
`iters` of the lanes)."""
from ._common import mean


def read(record: dict):
    return mean(record, "steps")
