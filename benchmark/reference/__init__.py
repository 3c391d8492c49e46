"""The plain references: each module rebuilds one kind of SANA-FE chip from
a configuration's description and the frozen architecture costs under
``data/``, in plain PyTorch and NumPy, and imports nothing of the program
under test, nor JAX or the JAX package.

A configuration names its module by the key ``reference`` of its JSON file
(``configs/<name>.json``); without the key it is ``chip``: LIF somas,
current-based synapses and no dendrite costs. ``noc.py`` is not a chip's
reference but the detailed-timing sweep that every module's ``Layout``
shares. What a module provides (``STATE_KEYS``, ``Layout``,
``Reference``, ``from_program``), the fields of its ``Layout`` that the
harness, the per-layer readers and ``noc.tables`` read, and how a module
reuses ``chip.py`` and replaces its soma alone, are set out in
``harness/spec.py``."""
