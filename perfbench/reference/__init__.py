"""Plain fp32 PyTorch references. They import nothing of the program:
they regenerate the inputs from the seed (``perfbench/world.py``) and
work out every derived weight themselves."""
