"""peak_device_gib.sirt: torch.cuda.max_memory_allocated over the window,
after reset_peak_memory_stats, GiB (the harness holds the tilt series
and the sampled answers besides the program)."""


def read(record):
    if "trace" not in record:
        return None
    return record["peak_window_bytes"] / 2 ** 30
