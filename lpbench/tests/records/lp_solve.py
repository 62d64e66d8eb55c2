"""The card record of the entry `lp_solve` (entries/lp_solve.py): a traced
record as the card gives it, at the staircase120 cell's sizes, and what
each of the entry's per-layer readers reads on it (the contract is in
lpbench/tests/records/batched_phase1.py). A request's info carries the
solve's spans and counters (solver.trace) under the trace's own names; a
request of a program without them has none, and the readers read None."""
import pytest


def _request(ipm1, factorize, kkt2, crossover, trips, finite=True):
    return {"finite": finite, "draw": 0, "steps": 40, "status": 1000,
            "ipxt.lp.ipm1": ipm1, "ipxt.lp.basis": 0.3, "ipxt.lp.ipm2": 8.8,
            "ipxt.lp.factorize": factorize, "ipxt.lp.kkt2": kkt2,
            "ipxt.lp.crossover": crossover, "kkt1_trips": 900,
            "kkt2_trips": trips, "basis_updates": 800,
            "lu_factorizations": 30, "host_syncs": trips + 40}


def card_record():
    """A traced record as the card gives it, at the staircase120 cell's
    sizes: two finished solves and one that ended without a vertex."""
    return dict(
        sizes=dict(m=90000, n=180000, nnz=450629), lanes=1,
        requests=[_request(0.8, 4.0, 4.5, 0.4, 497),
                  _request(0.9, 4.2, 4.7, 0.5, 503),
                  _request(9.9, 9.9, 9.9, 9.9, 9999, finite=False)],
        launches={"nnt": 1000, "cr_step": 40},
        window_peak_bytes=2 * 2 ** 30,
        trace=dict(kernels=[("void ipxt::nnt_kernel(...)", 1000, 0.5)],
                   busy_s=1.0, window_s=50.0, device_ops=[], idle_gaps=[]))


def expected():
    """{metric: what its reader reads on card_record()}: the means over
    the two finished solves."""
    return dict(lp_ipm1_s=pytest.approx(0.85),
                lp_factorize_s=pytest.approx(4.1),
                lp_kkt2_s=pytest.approx(4.6),
                lp_crossover_s=pytest.approx(0.45),
                lp_kkt2_trips=500.0)
