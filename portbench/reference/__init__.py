"""Plain float32 references, one module a configuration
(``<config>.py``), in plain PyTorch.  They import nothing of the program
and nothing of JAX: ``common`` holds what the configurations share."""
