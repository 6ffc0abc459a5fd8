"""The share of the K1 lists' slots that hold a Gaussian: the program's
tile-list counters over the window (``Trainer.events``: ``tile_entries``,
Σ min(count, k_tile) of the last step's tiles at each log point, over
``tile_slots``, n_tiles × k_tile), in percent.  K1 writes, and K3 fills,
every slot; the rest are padding.  None where the program keeps no such
counters."""


def read(record: dict):
    ev = record["window"]["events"]
    slots = ev.get("tile_slots")
    if not slots or "tile_entries" not in ev:
        return None
    return 100.0 * ev["tile_entries"] / slots
