"""Loop kinds, one module each, found by the name a traffic file gives in
``"loop"`` (``spec.loop``). A loop module exports:

- ``Loop(cell, seed, device)``: the program set up for the cell (built on
  ``drive.Program``), warmed up; ``item(i)`` runs one item of the window
  and ends in a synchronisation of the device; ``record()`` hands the check
  what the timed path produced; ``describe(setup_s, starts, ends)`` gives
  the ``drive.Run`` that the metric readers read;
- ``judge(cell, record, device) -> (numbers, work)``: each number compared
  (against ``limits/<cell>.json``) and the reference's
  ``BounceStats`` of the checked paths (the roofline's work, or None);
- ``FAULTS``: ``{name: context manager factory}``, the faults that a cell
  of this kind can have, planted under the timed path (``faults.py`` holds
  those that kinds share), which the check has to fail.
"""
