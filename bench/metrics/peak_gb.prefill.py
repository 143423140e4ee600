"""peak_gb.prefill: the card's peak of allocated memory over the window
(`torch.cuda.max_memory_allocated` after a reset at its start), in GB
(1e9 bytes)."""


def read(run):
    return run.memory_peak_bytes / 1e9 if run.on_card else None
