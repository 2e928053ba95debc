"""Procedural triangle meshes (a copy of the JAX package's numpy-only ``assets/meshes.py``)."""
