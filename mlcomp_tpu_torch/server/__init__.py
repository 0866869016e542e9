"""Server side of the port (counterpart of ``mlcomp_tpu/server``): the
serving process (``serve``), the DAG builder (``create_dags``) and the
scheduler's priority classes."""
