"""The plain reference: a SANA-FE chip of LIF neurons on a mesh of
identical tiles, rebuilt from a configuration's description and the frozen
architecture costs under ``data/``, in plain PyTorch and NumPy. It imports
nothing of the program under test, nor JAX or the JAX package."""
