"""Checkpoint/resume demo through ipx_tpu_torch, the port's counterpart of
examples/checkpoint_resume.py: stop a solve at an iteration limit, write
the state to disk, and finish the solve in a second solver.

Capability beyond the reference (SURVEY §5.4): the reference's only restart
path is a user-supplied warm start (reference: src/lp_solver.h:60-66); here
the exact pre-postsolve IPM state (iterate + variable state machine + basis)
round-trips through an .npz file, and the resumed solve continues directly
with basis-preconditioned iterations.

    python examples/torch_checkpoint_resume.py [--device cuda|torch_cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from ipx_tpu_torch import LpSolver, Parameters  # noqa: E402
from ipx_tpu_torch.testgen import (load_into_solver,  # noqa: E402
                                   transportation)


def main(device="cuda"):
    data = transportation(400, 600, 0.01, seed=7)
    ckpt_path = os.path.join(tempfile.mkdtemp(), "ipx_tpu_torch_ckpt.npz")

    # --- run 1: stop early (simulates a time limit / preemption) ---------
    p = Parameters(display=0, device=device)
    p.ipm_maxiter = 8                      # artificial interruption
    p.checkpoint_file = ckpt_path         # periodic + final state writes
    p.checkpoint_interval = 0.0           # write after every IPM iteration
    s1 = LpSolver(p)
    load_into_solver(data, s1)
    s1.solve()
    info1 = s1.get_info()
    print(f"run 1: stopped after {info1.iter} IPM iterations "
          f"(status_ipm={info1.status_ipm}), checkpoint at {ckpt_path}")

    # --- run 2: fresh solver, same model, resume and finish --------------
    s2 = LpSolver(Parameters(display=0, device=device))
    load_into_solver(data, s2)
    assert s2.load_checkpoint(ckpt_path) == 0
    status = s2.solve()
    info2 = s2.get_info()
    print(f"run 2: resumed at iteration {info1.iter}, finished at "
          f"{info2.iter} (status={status}, objective={info2.objval:.6f})")

    # --- reference run: uninterrupted solve ------------------------------
    s3 = LpSolver(Parameters(display=0, device=device))
    load_into_solver(data, s3)
    s3.solve()
    info3 = s3.get_info()
    print(f"uninterrupted: {info3.iter} iterations, "
          f"objective={info3.objval:.6f}")
    assert abs(info2.objval - info3.objval) < 1e-6 * max(1, abs(info3.objval))
    os.remove(ckpt_path)
    print("objectives match; checkpoint round trip exact")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "torch_cpu", "cpu", "auto"))
    main(ap.parse_args().device)
