"""Training steps per second: every step of every ``Trainer.run`` call in
the window, over the window's wall seconds on the host clock, which end in
a synchronisation.  Refines, growths, captures and the trainer's own host
reads are all inside."""


def read(record: dict):
    w = record["window"]
    return w["steps"] / w["seconds"]
