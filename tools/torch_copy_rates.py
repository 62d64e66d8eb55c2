"""The host's copy rates to and from the card, each way, for the sizes a
batched phase-1 request moves (parallel/batch.py: b and c up, the state
down), by the ways a copy can take.

    python tools/torch_copy_rates.py [--sizes 40960000,237572096,1230000000]
        [--reps 5]

Up (host to card), from an array the caller holds:
  pageable        torch.from_numpy(a).to(card), blocking;
  pageable_fresh  the same from a new host array filled from a first (what
                  a host transpose before the copy costs);
  staged          one contiguous host copy into a page-locked block of
                  torch's caching host allocator, then a non-blocking DMA;
  registered      cudaHostRegister on the caller's array, a non-blocking
                  DMA, cudaHostUnregister.
Down (card to host):
  pageable        tensor.cpu(), blocking, into a new array;
  pinned          a non-blocking DMA into a page-locked block of torch's
                  caching host allocator;
  registered      cudaHostRegister on a host array, a non-blocking DMA,
                  cudaHostUnregister.

Each is timed by the host's clock around the whole transfer, ended by a
synchronize, `--reps` times after one untimed first call (whose time,
which holds a page-locked block's allocation, prints as `first_s`).
Prints one JSON line: per size and way the median and best seconds and
GB/s, the card's name and power limit, torch's CPU threads. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def timed(fn, reps: int) -> dict:
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize(dev)
    first = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(dev)
        walls.append(time.perf_counter() - t0)
    return dict(first_s=first, median_s=statistics.median(walls),
                best_s=min(walls))


def ways(nbytes: int, reps: int) -> dict:
    dev = torch.device("cuda")
    cudart = torch.cuda.cudart()
    n = nbytes // 8
    host = np.random.default_rng(0).standard_normal(n)
    on_card = torch.from_numpy(host).to(dev)

    def register(a):
        rc = cudart.cudaHostRegister(a.ctypes.data, a.nbytes, 0)
        if int(rc) != 0:
            raise RuntimeError(f"cudaHostRegister returned {rc}")

    def up_registered():
        register(host)
        try:
            torch.from_numpy(host).to(dev, non_blocking=True)
            torch.cuda.synchronize(dev)
        finally:
            cudart.cudaHostUnregister(host.ctypes.data)

    def up_staged():
        st = torch.empty(n, dtype=torch.float64, pin_memory=True)
        st.copy_(torch.from_numpy(host))
        return st.to(dev, non_blocking=True)

    def down_pinned():
        blk = torch.empty(n, dtype=torch.float64, pin_memory=True)
        blk.copy_(on_card, non_blocking=True)
        return blk

    sink = np.empty(n)

    def down_registered():
        register(sink)
        try:
            torch.from_numpy(sink).copy_(on_card, non_blocking=True)
            torch.cuda.synchronize(dev)
        finally:
            cudart.cudaHostUnregister(sink.ctypes.data)

    got = dict(
        up_pageable=timed(lambda: torch.from_numpy(host).to(dev), reps),
        up_pageable_fresh=timed(
            lambda: torch.from_numpy(np.array(host)).to(dev), reps),
        up_staged=timed(up_staged, reps),
        up_registered=timed(up_registered, reps),
        down_pageable=timed(lambda: on_card.cpu(), reps),
        down_pinned=timed(down_pinned, reps),
        down_registered=timed(down_registered, reps),
    )
    for r in got.values():
        r["gb_per_s"] = nbytes / r["median_s"] / 1e9
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sizes", default="40960000,237572096,1230000000")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    torch.cuda.init()
    res = {s: ways(int(s), args.reps) for s in args.sizes.split(",")}
    print(json.dumps(dict(card=card(), torch=torch.__version__,
                          cpu_threads=torch.get_num_threads(),
                          cudart=sorted(n for n in dir(torch.cuda.cudart())
                                        if n.startswith("cuda")),
                          rates=res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
