"""Pallas kernels (Triton route): the whole LM solve in one kernel."""
