"""k7_roofline: the share of their roofline that the batched CR's two
elementwise passes reach, in %: the least time of their launches (bytes over
the card's memory rate, yardstick.k7_bytes: each array once, from m, B and
the element type) over their device time in the trace. The launches are the
port's K7 passes kPassCA (2) and kPassB (4) of bcr_elem_kernel
(csrc/batch_cr.cu), by name and template argument."""
from lpbench import yardstick

from ._common import roofline

KERNEL = r"bcr_elem_kernel<(float|double), ?([24])>"
PASS = {"2": "kPassCA", "4": "kPassB"}


def read(record: dict):
    s = record["sizes"]
    return roofline(record, KERNEL, lambda hit, dtype: yardstick.k7_bytes(
        s["m"], s["B"], dtype)[PASS[hit.group(2)]])
