"""Row-blocked ("sharded") solve of one LP through ipx_tpu_torch, the
port's counterpart of examples/sharded_solve.py.

`Parameters.shards = k` partitions the constraint rows of AI = [A I] into
k blocks and runs phase 1's diagonal-preconditioned CR over them, every
dot the ordered sum of the blocks' partials (ipx_tpu_torch/parallel/
sharding.py, ShardedDiagCR: K1/K5 per block, K14, K15). The reference
spreads the blocks over a jax mesh; here they live on the one device
"--device" names. Phase 2 then runs the column-blocked N N'
(ShardedSplittedNNt) on the same device.

    python examples/torch_sharded_solve.py [--device cuda|torch_cpu|auto]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(device="cuda"):
    from ipx_tpu_torch import LpSolver, Parameters
    import ipx_tpu_torch.testgen as tg

    data = tg.transportation(1000, 1500, 0.005, seed=3)
    m = data["num_constr"]

    # reference solve, the host path
    s0 = LpSolver(Parameters(display=0, device="cpu"))
    tg.load_into_solver(data, s0)
    t0 = time.perf_counter()
    assert s0.solve() == 1000
    t_single = time.perf_counter() - t0
    ref_obj = s0.get_info().pobjval

    # sharded solve over 4 row blocks
    s = LpSolver(Parameters(display=0, device=device, shards=4))
    tg.load_into_solver(data, s)
    t0 = time.perf_counter()
    status = s.solve()
    t_sharded = time.perf_counter() - t0
    info = s.get_info()
    cr = s.model._sharded_cr[1]
    nnt = getattr(s.model, "_sharded_nnt", None)

    print(f"m={m}: host {t_single:.2f}s, sharded(4) on {cr.device} "
          f"{t_sharded:.2f}s")
    print(f"status={status} objective={info.pobjval:.6f} "
          f"(reference {ref_obj:.6f}, "
          f"rel diff {abs(info.pobjval - ref_obj) / abs(ref_obj):.2e})")
    print(f"phase-1 row-blocked CR iterations: {info.kktiter1}; "
          f"phase-2 column-blocked N N' applies: "
          f"{nnt[1].applies if nnt else 0}")
    assert status == 1000
    assert abs(info.pobjval - ref_obj) <= 1e-7 * abs(ref_obj)
    assert cr.solves > 0 and nnt is not None and nnt[1].applies > 0
    print("OK")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    choices=("cuda", "torch_cpu", "cpu", "auto"))
    main(ap.parse_args().device)
