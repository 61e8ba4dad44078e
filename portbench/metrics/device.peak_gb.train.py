"""The most device memory held at once over set-up and window
(``torch.cuda.max_memory_allocated``), in GB."""
UNIT, LAYER, MOVES = "GB", "device", "train_tokens_per_s"


def read(rec):
    peak = rec.get("peak_bytes")
    return None if not peak else peak / 1e9
