"""The plain reference that decides whether a run is correct: plain PyTorch and numpy, nothing of the program."""
