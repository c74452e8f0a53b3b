"""Plain references: plain PyTorch, importing nothing of the program."""
