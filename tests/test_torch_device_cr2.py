"""K4 nnt and the port's phase-2 DeviceSplittedCR (plain version on the CPU)
against ipx_tpu.ops.device_cr2 on jax's CPU backend and against the host
SplittedNormalMatrix. Each package prepares its own operator from its own
host path on the same LP; the two host paths are the same code, so the
bases agree exactly."""
from time import monotonic

import numpy as np
import pytest
import torch

import ipx_tpu
import ipx_tpu.testgen as tg
import ipx_tpu_torch
from ipx_tpu.kkt import splitted_normal as ref_splitted
from ipx_tpu.ops.device_cr2 import DeviceSplittedCR as RefSplittedCR
from ipx_tpu_torch.kkt import splitted_normal as port_splitted
from ipx_tpu_torch.ops import device_cr2 as port

CPU = torch.device("cpu")


def _at_switch(pkg, splitted):
    """(model, SplittedNormalMatrix) of the host path of `pkg` right after
    the phase switch."""
    p = pkg.Parameters()
    p.display = 0
    p.device = "cpu"
    p.stop_at_switch = 1          # stop right after the basis is built
    s = pkg.LpSolver(p)
    tg.load_into_solver(tg.transportation(80, 120, 0.06, seed=9), s)
    s.solve()
    assert s.basis is not None
    md = s.basis.model
    sn = splitted.SplittedNormalMatrix(md)
    sn.prepare(s.basis, s.iterate.scaling_factors())
    return md, sn


@pytest.fixture(scope="module")
def prepared():
    """The port's (model, SplittedNormalMatrix) right after the phase
    switch."""
    return _at_switch(ipx_tpu_torch, port_splitted)


@pytest.fixture(scope="module")
def prepared_ref():
    """The reference's, on the same LP."""
    return _at_switch(ipx_tpu, ref_splitted)


def test_nnt_matches_reference(prepared, prepared_ref):
    """K4 against the reference's jitted N(N'w), float64 to 1e-12."""
    import jax.numpy as jnp
    md, sn = prepared
    md_ref, sn_ref = prepared_ref
    assert (sn.N != sn_ref.N).nnz == 0
    ref = RefSplittedCR(md_ref)
    ref.prepare(sn_ref)
    dcr = port.DeviceSplittedCR(md, CPU)
    dcr.prepare(sn)
    w = np.random.default_rng(1).standard_normal(md.num_rows)
    want = np.asarray(ref._fn(ref._nt_args, ref._n_args, jnp.asarray(w)))
    got = port.nnt(dcr._Nt, dcr._N, torch.from_numpy(w)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-12 * np.max(np.abs(want))


def test_device_splitted_cr_operator_equivalence(prepared, prepared_ref):
    """DeviceSplittedCR.solve solves C y = rhs for the same operator the
    host SplittedNormalMatrix applies, as the reference's does."""
    md, sn = prepared
    md_ref, sn_ref = prepared_ref
    rng = np.random.default_rng(0)
    rhs = rng.standard_normal(md.num_rows)
    if sn.free_positions.size:
        rhs[sn.free_positions] = 0.0
    ref = RefSplittedCR(md_ref)
    ref.prepare(sn_ref)
    y_r, it_r, err_r = ref.solve(rhs, tol=1e-10, maxiter=5000)
    dcr = port.DeviceSplittedCR(md, CPU)
    dcr.prepare(sn)
    y, iters, err = dcr.solve(rhs, tol=1e-10, maxiter=5000)
    assert err == err_r == 0 and iters > 0
    assert abs(iters - it_r) <= 2
    Cy, _ = sn._apply(y, want_dot=False)
    assert np.max(np.abs(rhs - Cy)) <= 1e-8 * max(1.0, np.abs(rhs).max())
    assert dcr.time_NNt > 0 and dcr.time_B > 0 and dcr.time_Bt > 0


def test_deadline_stops_with_999(prepared):
    md, sn = prepared
    dcr = port.DeviceSplittedCR(md, CPU)
    dcr.prepare(sn)
    rhs = np.random.default_rng(2).standard_normal(md.num_rows)
    if sn.free_positions.size:
        rhs[sn.free_positions] = 0.0
    y, iters, err = dcr.solve(rhs, tol=1e-14, maxiter=5000,
                              deadline=monotonic() - 1.0)
    assert err == 999 and iters == 0
    assert np.all(y == 0.0)
