"""Judges one request's answer: the state that the batched phase 1 returned
for every lane, against the inputs and against the plain reference's own
run of the same request (stage.py).

The numbers, each worst over the lanes (the limits are in PERF.md, the
readings they were set from beside them):

* ``bound_res``: the bound residuals rl = lb - x + xl and ru = ub - x - xu.
  The starting point makes them s and -s on every finite bound of a lane,
  and each step scales them by 1 - alpha_p, whatever its direction, so that
  they stay one number per lane, r and -r. Each entry's departure from its
  lane's r, over 1 + max |x| of the lane.
* ``dual_res``: the dual residual rc = c - [A I]'y - zl + zu. The starting
  point makes it 0 on a column with two finite bounds, -t on a column with
  a lower bound alone and t on one with an upper bound alone, and each step
  scales it by 1 - alpha_d: its departure from that pattern, over
  1 + max |c|. (It holds where the starting point needed no dual fix-up,
  as on the transportation LPs: PERF.md.)
* ``primal_res``: the primal residual b - [A I] x, over 1 + max |b| of the
  lane.
* ``mu_ratio``: |log10(mu / mu_ref)| of each lane that neither side has
  marked done, mu = the mean of xl zl and xu zu over the finite bounds,
  mu_ref the reference's after as many steps; of a lane that only the
  reference has marked done, log10(mu / mu_ref) where it is positive; 0 on
  a lane that the program has marked done (``flags`` holds that one).
  The one number taken against the reference's own run: it holds the dual
  part (Y, ZL, ZU) to the reference's progress, which the residuals above
  cannot, since a dual left where it started keeps rc's pattern.
* ``interior``: the lanes with a barrier part that is not positive or a
  value that is not finite (the limit is 0).
* ``flags``: the lanes whose `done` or `iters` disagree with the state: a
  lane done that fails the stage's convergence test, or a lane not done
  whose step count is not the stage's.
"""
from __future__ import annotations

import numpy as np
import torch

from .stage import Phase1


def _lane_max(x):
    return torch.amax(x, dim=0)


def judge(ref: Phase1, got: dict, want: dict) -> dict:
    """{name: reading} of the program's state `got` (numpy arrays, (dim, B)
    and (B,)) on the batch of `ref`, with `want` the reference's run."""
    t = ref.tensor
    ops, fl, fu = ref.ops, ref.fl, ref.fu
    X, XL, XU, Y, ZL, ZU = (t(got[k]) for k in ("X", "XL", "XU", "Y", "ZL",
                                                 "ZU"))
    where = torch.where
    bad = torch.zeros(X.shape[1], dtype=torch.bool, device=X.device)
    for v in (X, Y, where(fl, XL, 1.0), where(fu, XU, 1.0), ZL, ZU):
        bad |= ~torch.all(torch.isfinite(v), dim=0)
    for v, f in ((XL, fl), (XU, fu), (ZL, fl), (ZU, fu)):
        bad |= torch.any(f & ~(v > 0), dim=0)
    ok = ~bad
    xscale = 1.0 + _lane_max(torch.abs(X))

    RL = where(fl, ref.lb - X + XL, 0.0)
    RU = where(fu, ref.ub - X - XU, 0.0)
    # r of each lane: the median of its rl and -ru entries
    parts = torch.cat([where(fl, RL, float("nan")),
                       where(fu, -RU, float("nan"))], dim=0)
    r = torch.nanmedian(parts, dim=0).values
    dev = torch.maximum(_lane_max(torch.abs(where(fl, RL - r, 0.0))),
                        _lane_max(torch.abs(where(fu, RU + r, 0.0))))
    bound_res = dev / xscale

    RC = ref.cT - ops.AIt(Y) - ZL + ZU
    sign = (where(fl & ~fu, -1.0, 0.0) + where(fu & ~fl, 1.0, 0.0)).to(
        RC.dtype).expand_as(RC)
    one_sided = sign != 0
    tk = torch.nanmedian(where(one_sided, RC * sign, float("nan")),
                         dim=0).values
    tk = torch.nan_to_num(tk, nan=0.0)
    dual_res = _lane_max(torch.abs(RC - sign * tk)) / (
        1.0 + _lane_max(torch.abs(ref.cT)))

    RB = ref.bT - ops.AI(X)
    primal_res = _lane_max(torch.abs(RB)) / (1.0 + _lane_max(
        torch.abs(ref.bT)))

    mu = ref.mu(dict(XL=XL, XU=XU, ZL=ZL, ZU=ZU))
    mu_ref = ref.mu({k: t(want[k]) for k in ("XL", "XU", "ZL", "ZU")})
    # flags: a done lane passes the convergence test on its own state; a
    # lane not done took every step of the stage
    done = torch.as_tensor(np.asarray(got["done"], dtype=bool),
                           device=X.device)
    ref_done = torch.as_tensor(np.asarray(want["done"], dtype=bool),
                               device=X.device)
    gap = torch.log10(mu / mu_ref)
    # a lane that the reference finished and the program did not is held
    # to the reference's mu from above only: it may have stepped on below
    mu_ratio = torch.where(done, 0.0, torch.where(
        ref_done, torch.clamp(gap, min=0.0), torch.abs(gap)))
    iters = torch.as_tensor(np.asarray(got["iters"], dtype=np.int64),
                            device=X.device)
    test = ref.converged(dict(X=X, XL=XL, XU=XU, Y=Y, ZL=ZL, ZU=ZU))
    steps = int(iters.max())
    flags = (done & ~test) | (~done & (iters != steps))

    def worst(v):
        v = torch.where(ok & ~torch.isnan(v), v, float("inf"))
        return float(torch.amax(v))
    return dict(bound_res=worst(bound_res), dual_res=worst(dual_res),
                primal_res=worst(primal_res), mu_ratio=worst(mu_ratio),
                interior=float(bad.sum()), flags=float(flags.sum()))
