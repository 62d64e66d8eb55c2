"""The card record of the entry `batched_phase1` (entries/batched_phase1.py):
a traced record as the card gives it, at the 20k cell's sizes, and what each
of the entry's per-layer readers reads on it.

test_lpbench_rehearsal.py loads `lpbench/tests/records/<entry>.py` for every
entry that the cells of a per-layer metric run (the metric's `workloads` ->
`lpbench/traffic/<traffic>.json` -> its `entry`), and holds each reader of
those metrics to it: `card_record()` gives the record, on which every reader
returns a float and, emptied of what a window measures (no requests,
launches, trace or peak), None; `expected()` gives {metric: what its reader
reads}, compared with ==.

A record is what run.py hands the readers after a traced window: `sizes`
(entry.sizes()), `lanes`, `requests` (each request's `info` from
entry.serve, with `index`, `start_s`, `total_s`), `launches` (the
differences of entry.launches() over the window), `window_peak_bytes` and
`trace` (tracing.Tracer.summary(): `kernels` as (name, launches, device
seconds), `busy_s`, `window_s`, `device_ops`, `idle_gaps`).

What an entry gives the harness, so that a cell of a new entry comes as
files and new entries of BENCHMARK.json alone:

* `lpbench/entries/<entry>.py` with a class `Entry(config, traffic, seed,
  device)`: `config` the configuration's file, `traffic` the mix's file,
  `seed` the run's --seed (inputs and order drawn from it), `device` "cuda"
  or "torch_cpu" (the CPU rehearsal, the plain versions);
* `warm_up()`: the cell's own shapes run once, counted as set-up;
  `setup_phases`: {part: seconds} of its set-up, printed as `info setup.*`;
* `serve(i)`: request i, returning `(out, info)` once the device has
  finished; `info["finite"]` false counts the request as failed, and the
  other keys of `info` are what the readers find under `requests`;
* `check(i, out)`: {number: reading} of request i's answer against the
  plain reference, each number judged against its limit;
* `sizes()` (the shapes the readers' byte counts take), `launches()`
  ({kernel: launches so far}), `lanes` (scenarios a request: `scen_per_s`
  counts lanes), `pass_len` (requests in a whole pass over the work, the
  window's unit);
* `lpbench/limits/<entry>.json`: {number: limit} of `check`, set from the
  readings of sound runs and of the control and the faults on the card, by
  a script under `lpbench/` (readings.py drives this entry's);
* `lpbench/tests/records/<entry>.py`: this module's two functions for it;
* a plain reference under `lpbench/reference/` that imports nothing of the
  program (test_lpbench_imports.py imports every module there).
"""
import pytest

from lpbench import yardstick


def card_record():
    """A traced record as the card gives it, at the 20k cell's sizes."""
    k6 = "void ipxt::normal_batched_kernel<float, 4>(long, long, ...)"
    k6d = "void ipxt::normal_batched_kernel<double, 2>(long, long, ...)"
    ca = "void ipxt::bcr_elem_kernel<float, 2>(ipxt::BcrArgs<float>)"
    pb = "void ipxt::bcr_elem_kernel<double, 4>(ipxt::BcrArgs<double>)"
    other = "void ipxt::bcr_lane_kernel<float, 3>(ipxt::BcrArgs<float>)"
    blk = "void ipxt::block_normal_batched_kernel<float, 4>(long, ...)"
    return dict(
        sizes=dict(m=20000, n=96002, nnz=192004, B=256), lanes=256,
        requests=[dict(construct_s=0.4, steps=12, trips=6792, finite=True),
                  dict(construct_s=0.5, steps=12, trips=6792, finite=True)],
        launches={"normal_apply_batched": 14272, "batched_cr_step": 56336},
        window_peak_bytes=6 * 2 ** 30,
        trace=dict(kernels=[(k6, 9648, 9648 * 130e-6),
                            (k6d, 4624, 4624 * 260e-6),
                            (ca, 9648, 9648 * 77e-6),
                            (pb, 4624, 4624 * 128e-6),
                            (other, 9648, 9648 * 6.4e-6),
                            (blk, 10, 1.0)],
                   busy_s=7.0, window_s=8.0, device_ops=[], idle_gaps=[]))


def expected():
    """{metric: what its reader reads on card_record()}. K6: the fused
    launches alone (not the sharded block form), each launch's least time
    over its device time; K7: kPassCA (2) and kPassB (4) alike."""
    b32 = yardstick.bound_s(yardstick.k6_bytes(20000, 96002, 192004, 256,
                                               "f32"))
    b64 = yardstick.bound_s(yardstick.k6_bytes(20000, 96002, 192004, 256,
                                               "f64"))
    ca = yardstick.bound_s(yardstick.k7_bytes(20000, 256, "f32")["kPassCA"])
    pb = yardstick.bound_s(yardstick.k7_bytes(20000, 256, "f64")["kPassB"])
    return dict(
        construct_s=pytest.approx(0.45),
        ipm_steps=12,
        cr_trips=6792,
        launches_per_trip=pytest.approx(70608 / 13584),
        idle_share=pytest.approx(12.5),
        peak_mem_gib=6.0,
        k6_roofline=pytest.approx(
            100 * (9648 * b32 + 4624 * b64) / (9648 * 130e-6
                                               + 4624 * 260e-6)),
        k7_roofline=pytest.approx(
            100 * (9648 * ca + 4624 * pb) / (9648 * 77e-6 + 4624 * 128e-6)))
