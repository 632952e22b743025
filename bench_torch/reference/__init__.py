"""Plain PyTorch references of the configurations: no module of the port,
no kernel, no cache. They take nothing the port has made, only the inputs
and the initial weights that the harness draws from the seed."""
