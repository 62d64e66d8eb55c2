"""The slice end to end: ipx_tpu_torch.LpSolver with device="torch_cpu"
(the device path with the kernels' plain versions) against ipx_tpu, and the
device contract: no jax in the port, and no silent fallback from "cuda"."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import ipx_tpu
import ipx_tpu.testgen as tg
import ipx_tpu_torch
from ipx_tpu.status import SolveStatus, Status
from ipx_tpu_torch import backend, kernels
from ipx_tpu_torch.ops.device_cr import MixedPrecisionDeviceCR
from ipx_tpu_torch.ops.device_cr2 import DeviceSplittedCR

from lp_fixtures import afiro

AFIRO = -464.7531428566996
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _params(pkg, device, **kw):
    p = pkg.Parameters()
    p.display = 0
    p.device = device
    for k, v in kw.items():
        setattr(p, k, v)
    return p


@pytest.fixture
def device_calls(monkeypatch):
    """Iterations of every port device CR solve, by phase."""
    calls = {1: [], 2: []}
    for phase, cls in ((1, MixedPrecisionDeviceCR), (2, DeviceSplittedCR)):
        def counted(self, *args, _orig=cls.solve, _phase=phase, **kw):
            out = _orig(self, *args, **kw)
            calls[_phase].append(out[1])
            return out
        monkeypatch.setattr(cls, "solve", counted)
    return calls


def test_afiro(device_calls):
    s = ipx_tpu_torch.LpSolver(_params(ipx_tpu_torch, "torch_cpu"))
    assert afiro().load_into(s) == 0
    assert s.solve() == int(Status.SOLVED)
    info = s.get_info()
    # the crossover vertex is exact; the interior point meets the IPM's
    # optimality tolerance
    assert info.objval == pytest.approx(AFIRO, rel=1e-9)
    assert info.pobjval == pytest.approx(AFIRO, rel=1e-8)
    assert sum(device_calls[1]) > 0


@pytest.mark.parametrize("family", ["transport", "grid"])
def test_port_matches_reference_device_path(family, device_calls):
    data = (tg.transportation(120, 180, 0.05, seed=4) if family ==
            "transport" else tg.grid_flow(16, 16, seed=2))
    infos = {}
    for pkg, device in ((ipx_tpu, "tpu"), (ipx_tpu_torch, "torch_cpu")):
        s = pkg.LpSolver(_params(pkg, device))
        tg.load_into_solver(data, s)
        s.solve()
        infos[device] = s.get_info()
    port, ref = infos["torch_cpu"], infos["tpu"]
    assert port.status == ref.status == int(Status.SOLVED)
    assert port.objval == pytest.approx(ref.objval, rel=1e-8)
    # the port's device CRs carried both phases (no silent host path)
    assert sum(device_calls[1]) > 0 and sum(device_calls[2]) > 0
    assert port.kktiter1 > 0 and port.kktiter2 > 0 and port.time_cr2_NNt > 0


def test_resume_reference_checkpoint_in_port(device_calls):
    """A checkpoint written by ipx_tpu.LpSolver resumes in the port's
    phase 2 and reaches the same optimum."""
    s1 = ipx_tpu.LpSolver(_params(ipx_tpu, "cpu", ipm_maxiter=4))
    assert afiro().load_into(s1) == 0
    s1.solve()
    assert s1.get_info().status_ipm == int(SolveStatus.ITER_LIMIT)
    ckpt = s1.get_checkpoint()
    assert ckpt is not None

    s2 = ipx_tpu_torch.LpSolver(_params(ipx_tpu_torch, "torch_cpu"))
    assert afiro().load_into(s2) == 0
    assert s2.load_checkpoint(ckpt) == 0
    assert s2.solve() == int(Status.SOLVED)
    info = s2.get_info()
    assert info.objval == pytest.approx(AFIRO, rel=1e-9)
    assert info.iter >= s1.get_info().iter
    assert not device_calls[1] and sum(device_calls[2]) > 0


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import ipx_tpu_torch\n"
        "import ipx_tpu_torch.host\n"
        "import ipx_tpu_torch.parallel.batch\n"
        "import ipx_tpu_torch.parallel.batch2\n"
        "from lp_fixtures import afiro\n"
        "p = ipx_tpu_torch.Parameters(display=0, device='torch_cpu')\n"
        "s = ipx_tpu_torch.LpSolver(p)\n"
        "assert afiro().load_into(s) == 0\n"
        "assert s.solve() == 1000\n"
        "assert s.get_info().kktiter1 > 0\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.mark.parametrize("device", ["cpu", "torch_cpu"])
def test_second_lp_on_one_solver(device):
    """afiro, then grid_flow(8, 8, 1) on the same LpSolver: the second solve
    reaches the objective of a fresh solver. It runs in a subprocess, so
    that a crash in a native kernel (rc -11 before clear_model built a fresh
    Model) fails this test and not the worker."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'tests')\n"
        "import ipx_tpu_torch\n"
        "from ipx_tpu_torch.host import testgen as tg\n"
        "from lp_fixtures import afiro\n"
        f"p = ipx_tpu_torch.Parameters(display=0, device={device!r})\n"
        "s = ipx_tpu_torch.LpSolver(p)\n"
        "assert afiro().load_into(s) == 0 and s.solve() == 1000\n"
        "data = tg.grid_flow(8, 8, 1)\n"
        "assert tg.load_into_solver(data, s) == 0\n"
        "st = s.solve()\n"
        "fresh = ipx_tpu_torch.LpSolver(p)\n"
        "assert tg.load_into_solver(data, fresh) == 0\n"
        "assert fresh.solve() == 1000\n"
        "print(st, repr(s.get_info().objval), "
        "repr(fresh.get_info().objval))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.returncode, out.stderr[-2000:])
    st, obj, want = out.stdout.split()[-3:]
    assert int(st) == 1000
    assert float(obj) == pytest.approx(float(want), rel=1e-9)


@pytest.mark.parametrize("script", ["chip_smoke.py",
                                    "tools/torch_profile.py"])
def test_card_scripts_import_only_the_port(script):
    """The scripts that drive the port on the card import neither jax nor
    ipx_tpu, directly: the machine with the card has no jax, and the host
    pieces they need come through ipx_tpu_torch.host."""
    with open(os.path.join(REPO, script)) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    assert "ipx_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "ipx_tpu"}


def _solve_cuda():
    s = ipx_tpu_torch.LpSolver(_params(ipx_tpu_torch, "cuda"))
    assert afiro().load_into(s) == 0
    return s.solve()


def test_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        backend.resolve("cuda")
    # the solver reports the failure; it does not finish on the host
    assert _solve_cuda() == int(Status.INTERNAL_ERROR)
    # "auto" without a card is the host path
    assert backend.resolve("auto") is None


def test_cuda_with_a_failed_build_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(kernels, "_lib", None)

    def failed_build(force=False):
        raise RuntimeError("nvcc failed (1)")

    monkeypatch.setattr(kernels._build, "build", failed_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        backend.resolve("cuda")
    assert _solve_cuda() == int(Status.INTERNAL_ERROR)


def test_failed_phase2_device_solve_raises(monkeypatch):
    """ipx_tpu's KKTSolverBasis catches a failed device solve and finishes
    on the host; the port's raises instead."""
    def broken(self, *args):
        raise RuntimeError("device solve failed")

    monkeypatch.setattr(DeviceSplittedCR, "_solve", broken)
    s = ipx_tpu_torch.LpSolver(_params(ipx_tpu_torch, "torch_cpu"))
    tg.load_into_solver(tg.transportation(40, 60, 0.1, seed=3), s)
    assert s.solve() == int(Status.INTERNAL_ERROR)


def test_unknown_device_raises():
    with pytest.raises(ValueError, match="unknown device"):
        backend.resolve("tpu")
