"""Drivers of the cells: ``<entry>.py`` runs the program as a traffic mix's
``entry`` names it. Each has a ``Run(cell, seed, device)`` with ``setup()``,
``window(seconds)``, ``trace()``, ``release()`` and ``check()``."""
