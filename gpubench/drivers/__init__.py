"""How a traffic mix drives the program: ``drivers/<driver>.py`` for the
``driver`` a traffic file names. A driver's ``run(cell, seed, seconds,
trace, device, started)`` makes the cell's set-up, measures its window
(or, with ``trace``, traces a fixed number of units) and returns what
:mod:`gpubench.run` prints and judges; it reaches the configuration's
family through ``cell.family``. Its ``TINY`` holds the traffic's keys that
cut it to a CPU test's size."""
