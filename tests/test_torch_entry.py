"""ipx_tpu_torch.entry against __graft_entry__: entry()'s starting state and
one batched IPM step on the CPU (the plain versions of K5-K13, cr_dtype f64
as the reference's on jax's CPU) to 1e-8 of each array's largest entry, as
tests/test_torch_step.py compares a step; and dryrun_multichip(2) with its
asserts on the CPU.

The reference runs in a subprocess on jax's CPU backend, because importing
__graft_entry__ points jax's persistent compilation cache at the home
directory for the rest of the process; there HOME is the test's own
directory.
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ipx_tpu_torch import entry as port_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("X", "XL", "XU", "Y", "ZL", "ZU")

REFERENCE = r'''
import sys
import numpy as np
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_device", jax.local_devices(backend="cpu")[0])
import __graft_entry__ as g
step, (state,) = g.entry()
out = step(state)
np.savez(sys.argv[1], **{"start_" + k: np.asarray(v) for k, v in state.items()},
         **{"step_" + k: np.asarray(v) for k, v in out.items()})
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's starting state and step output, as numpy."""
    tmp = tmp_path_factory.mktemp("graft_entry")
    path = str(tmp / "entry.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="1",
               HOME=str(tmp))
    out = subprocess.run([sys.executable, "-c", REFERENCE, path], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _close(got, want, tol=1e-8):
    """Equal infinities; finite entries within tol of the largest."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    assert np.array_equal(got[~fin], want[~fin])
    scale = max(np.max(np.abs(want[fin])), 1e-300)
    return np.max(np.abs(got[fin] - want[fin])) <= tol * scale


def test_entry_matches_reference(reference):
    """The port's starting state, then one step from it, against the
    reference's on jax's CPU."""
    step, (state,) = port_entry.entry(device="torch_cpu")
    assert state["X"].device.type == "cpu"
    for k in KEYS:
        assert _close(state[k], reference["start_" + k]), k
    assert state["cr"] == int(reference["start_cr"])
    out = step(state)
    for k in KEYS + ("mu",):
        assert _close(out[k], reference["step_" + k]), k
    assert np.array_equal(out["done"].numpy(), reference["step_done"])
    assert np.array_equal(out["iters"].numpy(), reference["step_iters"])
    assert out["cr"] == int(reference["step_cr"])


def test_entry_defaults_to_the_card(monkeypatch):
    """entry() and dryrun_multichip() with no device ask for the card, and
    raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="is_available"):
        port_entry.dryrun_multichip(2)


def test_dryrun_multichip_two_blocks(monkeypatch):
    """dryrun_multichip(2) on the CPU passes its asserts: the batched step
    at batch 8, the row-blocked CR over 2 blocks, the shards=2 full solve
    of the 10k-row LP at the host's pobjval with the column-blocked N N'
    engaged, and the batched CR over 1 block. It stays on the CPU where a
    card is present: nothing of it asks for the card."""
    from ipx_tpu_torch import backend

    def no_card():
        raise AssertionError("dryrun_multichip(device='torch_cpu') asked "
                             "for the card")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(backend, "cuda_device", no_card)
    t0 = time.perf_counter()
    port_entry.dryrun_multichip(2, device="torch_cpu")
    print(f"dryrun_multichip(2, device='torch_cpu'): "
          f"{time.perf_counter() - t0:.1f} s")
