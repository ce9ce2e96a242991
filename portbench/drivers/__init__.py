"""Drivers, one a kind of traffic (``<driver>.py``, named by the mix):
each builds the program, warms it up, runs the window, checks the timed
path's output against the reference and returns the run's result."""
