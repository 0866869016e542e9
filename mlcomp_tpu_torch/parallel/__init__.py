"""Mesh-spec arithmetic the DAG builder validates against
(``mlcomp_tpu/parallel/meshspec.py``); meshes themselves are A4."""
