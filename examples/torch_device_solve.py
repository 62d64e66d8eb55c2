"""Device solve: both interior-point phases carried by the card, through
ipx_tpu_torch, the port's counterpart of examples/device_solve.py.

`Parameters.device = "cuda"` (the default) routes

  * the phase-1 diagonal-preconditioned CR, the whole loop on the card
    (mixed precision: float32 recurrences with float64 defect correction,
    ipx_tpu_torch/ops/device_cr.py, K1-K3), and
  * the N N' product of the phase-2 basis-preconditioned CR (K4,
    ipx_tpu_torch/ops/device_cr2.py)

while the sequential runtime (LU, maxvolume, crossover) stays on the host.
"--device torch_cpu" runs the same path with the kernels' plain PyTorch
versions on the CPU.

    python examples/torch_device_solve.py [--device cuda|torch_cpu]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(device="cuda"):
    import torch
    from ipx_tpu_torch import LpSolver, Parameters, backend
    import ipx_tpu_torch.ops.device_cr2 as d2
    import ipx_tpu_torch.testgen as tg

    where = backend.resolve(device)
    print("device:", torch.cuda.get_device_name(where)
          if where.type == "cuda" else where)
    data = tg.transportation(800, 1200, 0.01, seed=4)

    # host reference
    s0 = LpSolver(Parameters(display=0, device="cpu"))
    tg.load_into_solver(data, s0)
    assert s0.solve() == 1000
    ref_obj = s0.get_info().pobjval

    # count the device phase-2 engagements (no silent host path)
    calls = []
    orig = d2.DeviceSplittedCR.solve

    def counted(self, *a, **k):
        out = orig(self, *a, **k)
        calls.append(out[1])
        return out

    d2.DeviceSplittedCR.solve = counted
    try:
        s = LpSolver(Parameters(display=0, device=device))
        tg.load_into_solver(data, s)
        t0 = time.perf_counter()
        status = s.solve()
        dt = time.perf_counter() - t0
    finally:
        d2.DeviceSplittedCR.solve = orig

    info = s.get_info()
    print(f"device solve: status={status} in {dt:.2f}s "
          f"(objective {info.pobjval:.6f}, host {ref_obj:.6f})")
    print(f"phase-2 KKT solves on the device: {len(calls)} "
          f"({sum(calls)} CR iterations)")
    assert status == 1000
    assert abs(info.pobjval - ref_obj) <= 1e-7 * abs(ref_obj)
    assert calls, "device phase-2 never engaged"
    print("OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "torch_cpu"))
    main(ap.parse_args().device)
