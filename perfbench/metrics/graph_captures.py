"""CUDA graph captures over the window: ``Trainer.events["capture"]``."""


def read(record: dict):
    return record["window"]["events"].get("capture")
