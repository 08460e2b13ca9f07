"""Data parallelism: the JAX package's 1-D ``data`` mesh, for inference in
one process over a list of devices and for training over a
``torch.distributed`` process group."""
