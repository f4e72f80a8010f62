"""Percent of the card's bf16 peak that the window's requests used:
the reference's counted products of each image at its camera's shape, over
every image completed in the traced run's window, over the window's
seconds. Counts the algorithm's work, never the program's."""

from benchmark.harness.readers import mfu as read  # noqa: F401
