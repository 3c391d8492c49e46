"""The benchmark's own code: loading cells by name, building a described
network through the port's builder API, timing, traces and the comparison
that decides ``correct``. Nothing here imports JAX or the JAX package."""
