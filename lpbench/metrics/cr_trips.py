"""cr_trips: the mean over requests of the stage's batched CR trips (its
returned `cr`), each one batched normal apply over all lanes."""
from ._common import mean


def read(record: dict):
    return mean(record, "trips")
