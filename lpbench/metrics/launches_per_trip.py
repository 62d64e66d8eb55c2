"""launches_per_trip: the program's kernel launches in the window
(kernels.LAUNCHES) over the CR trips of the requests that ran in it."""


def read(record: dict):
    trips = sum(r["trips"] for r in record["requests"])
    launches = sum(record["launches"].values())
    return launches / trips if trips > 0 and launches > 0 else None
