"""The plain reference: products and CG in PyTorch, each problem's operator
rebuilt from its configuration's formula.  Imports nothing of the program."""
