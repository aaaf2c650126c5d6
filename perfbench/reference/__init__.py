"""The plain reference that decides ``correct``: plain PyTorch, written from
the published architectures and the precision the configuration states.
It imports nothing of the program and takes nothing the program made."""
