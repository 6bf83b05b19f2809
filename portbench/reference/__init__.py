"""The plain reference (``plain.py``) and the comparison that decides ``correct``
(``compare.py``). Neither imports the port, JAX or the JAX package."""
