"""Drivers: the code of a kind of traffic.  A traffic file
(``perfbench/traffic/<mix>.json``) is data; its ``driver`` names a module
here, which the harness imports by that name and calls as

    run = setup(cfg, traffic, seed, device, log)

with the configuration file's and the traffic file's contents, the seed and
the device; ``log(msg)`` writes a line of set-up to standard error.  The
object it returns has

- ``window(seconds, record=None) -> dict``: the measured window, with
  ``steps`` (the work done, as the end-to-end rate counts it), ``seconds``
  (its wall seconds, ending in a synchronisation), ``events`` (counters of
  the program over the window) and ``t0`` (its start on
  ``time.perf_counter``); with a ``record`` (a traced run) it adds what the
  per-layer readers read: ``_prof`` and ``traced_s`` from
  ``trace.profile_call``, ``profiled_steps``, ``spans``;
- ``report(file)``: lines on the program after the window;
- ``free()``: drops the program's state, before the check;
- ``readings(device) -> dict``: the numbers the check compares, each
  judged against ``perfbench/limits/<cell>.json``;
- ``work(record, device) -> dict`` (traced runs): the counts of
  ``perfbench/counts`` that the rooflines and ``step_mfu`` divide.

So a mix of an existing kind is a new data file, and a new kind of traffic
is a new module here beside it: neither edits a file already there.
"""
