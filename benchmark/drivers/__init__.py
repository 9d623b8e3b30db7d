"""Drivers, one module per kind of program entry: each builds the program
from a cell, runs the set-up, the measured window and the check, and
returns a ``record.Run`` and an ``Outcome``."""
