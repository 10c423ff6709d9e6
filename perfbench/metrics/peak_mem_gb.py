"""peak_mem_gb: torch.cuda.max_memory_allocated over the window, in GB
(1e9 bytes)."""


def read(run):
    peak = run.window.get("peak_bytes")
    return None if peak is None else peak / 1e9
