"""Recorders of the random draws in a model's forward, one module a kind
of draw, found by the names in a reference model's ``DRAWS``.  Each holds
a ``Recorder``: a context manager that records the draws of every call
while inside, and whose ``attach(steps)`` hands each recorded batch its
own draws as ``b["draws"]`` (keyword arguments of the reference model's
forward) and returns the number of draws that break the draw's rule."""
