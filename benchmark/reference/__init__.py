"""The plain reference: float32 PyTorch and NumPy, nothing of the program."""
