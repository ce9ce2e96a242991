"""peak_gib.train: the most memory the program held on the card during
the training window (``torch.cuda.max_memory_allocated`` after a reset at
the window's start), in GiB."""

UNIT = "GiB"


def read(data: dict):
    if data.get("kind") != "train" or data["window_peak_bytes"] <= 0:
        return None
    return data["window_peak_bytes"] / 2**30
