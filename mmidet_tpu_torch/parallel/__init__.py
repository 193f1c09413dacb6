"""Data and tensor parallelism: the ('data', 'model') mesh of process
groups (``mesh``), the collectives with their adjoints (``comm``) and the
launcher of one process a rank (``launch``)."""
