"""peak_mem_gib: the device memory the window's requests took at their
peak, torch.cuda.max_memory_allocated() after reset_peak_memory_stats() at
the window's start, in GiB."""


def read(record: dict):
    peak = record.get("window_peak_bytes")
    return peak / 2 ** 30 if peak else None
