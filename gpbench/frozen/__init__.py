"""Frozen copies of the program's counts, tables and generators.

Each module is headed by the ``gpscore_torch`` file and lines it was copied
from. The copies are the benchmark's yardstick: a change to the program does
not move them, and the program never imports them.
"""
