"""Training on several devices: process groups, meshes, row-sharded tables
(``mesh.py``)."""
