"""lp_kkt2_trips: the mean over finished requests of phase 2's CR trips (the
counter kkt2_trips, equal to Info.kktiter2)."""
from ._lp import mean_of


def read(record: dict):
    return mean_of(record, "kkt2_trips")
