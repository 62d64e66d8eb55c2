"""The port's counterpart of ipx_tpu/native/build.py: builds libipxlu.so
from ipxlu.cc in this folder into ``ipx_tpu_torch/_build/``. The build is
ipx_tpu_torch/build.py's build_native, which shares its lock, freshness test
and atomic rename with the CUDA kernel library's. Run
``python -m ipx_tpu_torch.native.build [--force]`` to build by hand.
"""
from __future__ import annotations

import sys

from ..build import NATIVE_LIB as LIB, build_native as build

__all__ = ["LIB", "build"]

if __name__ == "__main__":
    print(build(force="--force" in sys.argv))
