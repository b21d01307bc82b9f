"""Plain references of the configurations: plain PyTorch, nothing of the program."""
