"""Set-up seconds: process start to the window's first step (the scene
and start state from the seed, the kernels' build where the checkout has
none, the trainer, the resume, the check steps and the graph captures)."""


def read(record: dict):
    return record["setup_s"]
