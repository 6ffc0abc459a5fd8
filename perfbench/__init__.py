"""The benchmark of the PyTorch and CUDA port, ``touchgs_torch``: one
training job a cell, driven through the program's ``Trainer.run``, checked
against a plain reference (``reference/``).  ``run.py`` is the entry."""
