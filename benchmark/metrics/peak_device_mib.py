"""torch.cuda.max_memory_allocated() over set-up and the window, in MiB."""


def read(run: dict):
    return run["peak_bytes"] / 2**20 if run["peak_bytes"] else None
