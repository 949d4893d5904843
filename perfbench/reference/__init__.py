"""Plain PyTorch references of the benchmark's configuration families, one
module a ``model_type``.  They import nothing of the program: they read a
configuration file and the benchmark's weights, and work out every dense
weight, cache and route themselves."""
