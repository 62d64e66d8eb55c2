"""k6_roofline: the share of its roofline that the batched normal apply
C V = A (W_s * (A' V)) + W_slack * V reaches, in %: the least time of its
launches (bytes over the card's memory rate, yardstick.k6_bytes: each input
read once, each output written once, from m, n, nnz, B and the element
type) over their device time in the trace. The launches are the port's K6
kernel (csrc/spmm.cu), by name."""
from lpbench import yardstick

from ._common import roofline

KERNEL = r"(?<!\w)normal_batched_kernel<(float|double)\b"


def read(record: dict):
    s = record["sizes"]
    return roofline(record, KERNEL, lambda hit, dtype: yardstick.k6_bytes(
        s["m"], s["n"], s["nnz"], s["B"], dtype))
