"""Plain PyTorch reference of a Touch-GS training step.  It imports nothing
of the program under test."""
