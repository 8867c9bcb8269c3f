"""The plain PyTorch reference that decides ``correct``: imports neither
JAX nor the program, and takes nothing the program has made."""
