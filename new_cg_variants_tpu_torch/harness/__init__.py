"""Experiment drivers: the convergence (``figure_gen``) and scaling
harnesses, and their figures."""
