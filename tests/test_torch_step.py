"""The plain versions of K10-K13 (ipx_tpu_torch/parallel/batch.py) against
ipx_tpu's batched step on jax's CPU backend, on an LP whose variables are
boxed, bounded below only, above only, and free, with equality rows, and
on a state with lanes already done.

K10's residuals are elementwise, so they agree to rounding (1e-12 of each
column's largest entry); its sums, and mu, run in another order than jnp's
(1e-12 relative). `done` is compared at a limit set between two lanes'
gaps, so that no lane sits within rounding of it.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipx_tpu.parallel import batch as ref
from ipx_tpu.parallel import batch2 as ref2
from ipx_tpu_torch.parallel import batch as port
from ipx_tpu_torch.parallel import batch2 as port2

from test_batched import make_batch

INF = np.inf


def _rel_cols(got, want):
    """Per column: max |got - want| over the column's largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want), axis=0) / np.maximum(
        np.max(np.abs(want), axis=0), 1e-300)


def _mixed_batch(B=5, seed=21):
    """make_batch's LP with its bounds redrawn: structural variables boxed,
    lower-bounded, upper-bounded or free; slacks of '<', '>' and '='
    rows."""
    _, blp = make_batch(B=B, seed=seed)
    m, n = blp.A.shape
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 4, n)        # boxed, lower, upper, free
    lb = np.where(kind <= 1, -rng.uniform(0.0, 1.0, n), -INF)
    ub = np.where((kind == 0) | (kind == 2), rng.uniform(1.0, 3.0, n), INF)
    rows = rng.integers(0, 3, m)        # '<', '>', '='
    slb = np.where(rows == 1, -INF, 0.0)
    sub = np.where(rows == 0, INF, 0.0)
    blp.lb = np.concatenate([lb, slb])
    blp.ub = np.concatenate([ub, sub])
    fl, fu = np.isfinite(blp.lb), np.isfinite(blp.ub)
    assert (fl & fu).any() and (fl & ~fu).any() and (~fl & fu).any() \
        and (~fl & ~fu).any()
    return blp


def _start(blp, **kw):
    """The reference's starting point of blp as numpy, with lanes 1 and 3
    marked done; the reference and port solvers."""
    r = ref.BatchedPhase1Solver(blp, **kw)
    p = port.BatchedPhase1Solver(port.as_batched_lp(blp), device="torch_cpu",
                                 **kw)
    S = {k: np.array(v) for k, v in r._start_fn(r._ops_tree, 0).items()}
    S["done"][[1, 3]] = True
    return r, p, S


def _torch(S):
    return {k: (torch.from_numpy(v.copy()) if np.ndim(v) else int(v))
            for k, v in S.items()}


def _jnp(S):
    return {k: jnp.asarray(v) for k, v in S.items()}


def test_residuals_and_mu_match_reference():
    """_residuals and _mu_of through the plain K10 against the reference:
    RB, RC, RL, RU within 1e-12 of each column's largest entry, mu within
    1e-12 relative."""
    r, p, S = _start(_mixed_batch())
    got = p._residuals(_torch(S))
    want = r._residuals(_jnp(S))
    for k, a, b in zip(("RB", "RC", "RL", "RU"), got, want):
        assert a.shape == b.shape, k
        assert np.all(_rel_cols(a.numpy(), b) <= 1e-12), k
    mu = p._mu_of(_torch(S)).numpy()
    mu_r = np.asarray(r._mu_of(_jnp(S)))
    assert np.all(np.abs(mu - mu_r) <= 1e-12 * np.abs(mu_r))
    # free variables keep RL = RU = 0 and the infinite XL / XU out
    fl = np.isfinite(r.lp.lb)
    assert np.all(got[2].numpy()[~fl] == 0.0)


def test_convergence_test_matches_one_reference_step():
    """done and mu of the plain K10 against one reference _step_fn from the
    same state, at an optimality limit between two lanes' gaps: some lanes
    pass the test, the lanes done before stay done."""
    blp = _mixed_batch()
    _, p, S = _start(blp)
    probe = p._prologue(_torch(S))
    gaps = np.sort(probe.gap.numpy())
    opt_tol = float(np.sqrt(gaps[1] * gaps[2]))
    kw = dict(feasibility_tol=1e30, optimality_tol=opt_tol)
    r, p, S = _start(blp, **kw)
    P = p._prologue(_torch(S))
    out_r = r._step_fn(r._ops_tree, _jnp(S))
    done_r = np.asarray(out_r["done"])
    assert np.array_equal(P.done.numpy(), done_r)
    assert done_r[[1, 3]].all() and done_r.sum() >= 3 and not done_r.all()
    mu_r = np.asarray(out_r["mu"])
    assert np.all(np.abs(P.mu.numpy() - mu_r) <= 1e-12 * np.abs(mu_r))


def test_kkt_weights_match_reference_polish():
    """K10's weights (the plain version, through the port polish's
    _weights_of) against the reference SharedBasisBatchedPolish._weights_of:
    equal where G > 0 (1/G), within 1e-12 where W is 1/regval (regval may
    be mu, whose sum rounds in another order); resscale is 1/sqrt(W[n:])."""
    blp = _mixed_batch()
    r, p, S = _start(blp)
    want = ref2.SharedBasisBatchedPolish._weights_of(
        types.SimpleNamespace(_ph1=r), S)
    pol = port2.SharedBasisBatchedPolish(port.as_batched_lp(blp), None,
                                         device="torch_cpu")
    got = pol._weights_of(_torch(S)).numpy()
    fl, fu = np.isfinite(blp.lb)[:, None], np.isfinite(blp.ub)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        G = np.where(fl, S["ZL"] / S["XL"], 0.0) \
            + np.where(fu, S["ZU"] / S["XU"], 0.0)
    pos = G > 0
    assert pos.any() and (~pos).any()
    assert np.array_equal(got[pos], want[pos])
    assert np.all(np.abs(got - want) <= 1e-12 * np.abs(want))
    # torch's reciprocal on the CPU may differ from numpy's by one ulp
    rs = p._prologue(_torch(S)).resscale.numpy()
    want_rs = 1.0 / np.sqrt(got[p.n:])
    assert np.all(np.abs(rs - want_rs) <= 1e-15 * want_rs)


@pytest.mark.parametrize("cr_dtype", ["f64", "f32"])
def test_starting_point_mixed_bounds(cr_dtype):
    """The starting point (the plain K13 between the two CR solves) on the
    mixed-bounds LP against the reference, within 1e-8 of each array's
    largest entry; infinities where the bounds are."""
    blp = _mixed_batch(B=4, seed=22)
    r = ref.BatchedPhase1Solver(blp, cr_dtype="f64")
    p = port.BatchedPhase1Solver(port.as_batched_lp(blp), device="torch_cpu",
                                 cr_dtype="f64")
    if cr_dtype == "f32":   # the reference's f32 path needs the operands
        r = ref.BatchedPhase1Solver(blp, cr_dtype="f32")
        p = port.BatchedPhase1Solver(port.as_batched_lp(blp),
                                     device="torch_cpu", cr_dtype="f32")
    S_r = r._start_fn(r._ops_tree, 0)
    S_p = p._starting_point()
    for k in ("X", "XL", "XU", "Y", "ZL", "ZU"):
        want, got = np.asarray(S_r[k]), S_p[k].numpy()
        fin = np.isfinite(want)
        assert np.array_equal(fin, np.isfinite(got)), k
        assert np.array_equal(got[~fin], want[~fin]), k
        tol = 1e-8 if cr_dtype == "f64" else 1e-4
        scale = max(np.max(np.abs(want[fin])), 1e-300)
        assert np.max(np.abs(got[fin] - want[fin])) <= tol * scale, k
    fl, fu = np.isfinite(blp.lb), np.isfinite(blp.ub)
    assert np.all(S_p["XL"].numpy()[~fl] == INF)
    assert np.all(S_p["ZU"].numpy()[~fu] == 0.0)


def test_one_step_mixed_bounds_with_done_lanes():
    """One _ipm_step (the plain K10-K12 around the CR, K8, K9) on the
    mixed-bounds LP with two lanes done, against the reference's _step_fn:
    every array within 1e-8 of its largest entry, the done lanes unchanged
    bit for bit."""
    r, p, S = _start(_mixed_batch(), cr_dtype="f64")
    S["cr"] = np.int64(0)
    out_p = p._ipm_step(_torch(S))
    out_r = r._step_fn(r._ops_tree, _jnp(S))
    for k in ("X", "XL", "XU", "Y", "ZL", "ZU"):
        want, got = np.asarray(out_r[k]), out_p[k].numpy()
        fin = np.isfinite(want)
        assert np.array_equal(fin, np.isfinite(got)), k
        scale = max(np.max(np.abs(want[fin])), 1e-300)
        assert np.max(np.abs(got[fin] - want[fin])) <= 1e-8 * scale, k
        assert np.array_equal(got[:, [1, 3]], S[k][:, [1, 3]]), k
    assert np.array_equal(out_p["done"].numpy(), np.asarray(out_r["done"]))
    assert out_p["cr"] == int(out_r["cr"])
