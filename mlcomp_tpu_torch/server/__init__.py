"""Server side of the port (counterpart of ``mlcomp_tpu/server``): the
site (the JSON API ``api``, the dashboard ``front``, the supervisor tick
``supervisor`` with its leader lease ``ha``), the serving process
(``serve``), the DAG builder (``create_dags``) and the scheduler's
priority classes."""
