"""Each example of the port (examples/torch_*.py) runs end to end with
--device torch_cpu, the device path with the kernels' plain versions on the
CPU, in a fresh process, and prints its last line. Left out:
torch_batch_scenarios_1000.py, 1024 scenario LPs, which the card runs."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# example: the start of the last line it prints
EXAMPLES = {
    "torch_afiro.py": "vbasis =",
    "torch_device_solve.py": "OK",
    "torch_batch_scenarios.py": "objectives:",
    "torch_batch_polish.py": "  scenario 3: objective",
    "torch_sharded_solve.py": "OK",
    "torch_checkpoint_resume.py": "objectives match",
}


def test_every_example_is_listed():
    names = {f for f in os.listdir(os.path.join(REPO, "examples"))
             if f.startswith("torch_") and f.endswith(".py")}
    assert names == set(EXAMPLES) | {"torch_batch_scenarios_1000.py"}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_torch_cpu(name):
    out = subprocess.run(
        [sys.executable, os.path.join("examples", name), "--device",
         "torch_cpu"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith(EXAMPLES[name]), last
